"""Fused dequantize+matmul for Q6_K weights: kernel K2 and its plain version.

Same contract as `mmq_q4_k` (output (N, M) float32, "fast" = bf16-rounded
operands with f32 accumulation) for Q6_K weights, whose element value is
d * scale16 * (q - 32) with q = ql nibble | qh crumb << 4. Counterpart of
`gguf_tpu/ops/mmq_q6_k.py:mmq_q6_k` (Pallas `_kernel_ink` and `_kernel`);
the CUDA source is `gguf_tpu_torch/csrc/mmq_q6_k.cu`: "fast" runs its bf16
tensor-core tile (`launch_tc`), "high" its SIMT f32 tile. It reads the
per-field arrays `QuantWeight` splits Q6_K's 210-byte blocks into.
`act_quant=True` fake-quantizes the activations to Q8_1 first (K6) at
any width, as the JAX package does (default False, see `mmq_q4_k`).

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K2 or raises. `mmq_q6_k.launches` counts K2 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import QuantWeight
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, launch_tc, matmul_plain

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q6_k_launch": [_VP] * 6 + [_I] * 5 + [_VP],
        "mmq_q6_k_tc_launch": [_VP] * 8 + [_I] * 6 + [_VP]}


def dequantize_q6_k_plain(w: QuantWeight) -> torch.Tensor:
    """(M, K) float32 in torch ops on the weight's device, bit-equal to
    the JAX package's dequantize ((d*scale) * (q-32))."""
    if w.fmt != "q6_k":
        raise ValueError(f"expected a q6_k weight, got {w.fmt}")
    return w.dequantize()


def mmq_q6_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of K2 (any device)."""
    check_operands(w, b, "q6_k", None)
    return matmul_plain(b.float(), dequantize_q6_k_plain(w), precision)


def _lib():
    return build.load("mmq_q6_k", _SIG)


def mmq_q6_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q6_K weights A (M, K) and B (N, K); (N, M) f32."""
    check_precision(precision)
    k = check_operands(w, b, "q6_k", None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_q6_k_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q6_k runs on cpu or cuda, not {b.device}")
    m, n = w.shape[0], b.shape[0]
    f = w.fields
    if precision == "fast":
        out = launch_tc(_lib().mmq_q6_k_tc_launch, w, b,
                        [(f["ql"], 16), (f["qh"], 16), (f["sc"], 8),
                         (f["d"], 2)], "mmq_q6_k")
    else:
        b = b.contiguous()
        out = torch.empty((n, m), dtype=torch.float32, device=b.device)
        if n == 0:
            return out
        build.check(_lib().mmq_q6_k_launch(
            build.ptr(f["ql"]), build.ptr(f["qh"]), build.ptr(f["sc"]),
            build.ptr(f["d"]), build.ptr(b), build.ptr(out), m, n, k,
            b.shape[1], int(b.dtype == torch.bfloat16), build.stream_ptr()),
            "mmq_q6_k")
    if n:
        mmq_q6_k.launches += 1
    return out


mmq_q6_k.launches = 0
