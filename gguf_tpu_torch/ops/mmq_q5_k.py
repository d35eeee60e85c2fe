"""Fused dequantize+matmul for Q5_K weights: kernel K8 and its plain version.

Same contract as `mmq_q4_k` (output (N, M) float32, "fast" = bf16-rounded
operands with f32 accumulation, `act_quant` routed to K5 + K7 under "high"
at n <= 16 and to K6 + K8 otherwise) for Q5_K weights, whose element value
is (d*sc)*q - dmin*mn with a 5-bit q: the Q4_K nibble plus a fifth bit
from the block's qh bytes. No `glu`: the JAX package never fuses the
gated activation into a Q5_K down projection. Counterpart of
`gguf_tpu/ops/mmq_q5_k.py:mmq_q5_k` (Pallas `_kernel_ink` and `_kernel`);
the CUDA source is `gguf_tpu_torch/csrc/mmq_q5_k.cu`. "fast" runs K1's
bf16 tensor-core tile (`csrc/kquant_tc.cuh`) with the fifth bit, split as
K1 splits (`k1_plan`); "high" runs the SIMT f32 tile of `csrc/kquant.cuh`.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K8 or raises. `mmq_q5_k.launches` counts K8 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import QuantWeight
from . import build
from .mmq_q4_k import (check_operands, check_precision, k1_plan, launch_tc,
                       matmul_plain, route_act_quant)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q5_k_launch": [_VP] * 3 + [_I] * 5 + [_VP],
        "mmq_q5_k_tc_launch": [_VP] * 5 + [_I] * 6 + [_VP]}


def dequantize_q5_k_plain(w: QuantWeight) -> torch.Tensor:
    """(M, K) float32 in torch ops on the weight's device, bit-equal to
    the JAX package's dequantize."""
    if w.fmt != "q5_k":
        raise ValueError(f"expected a q5_k weight, got {w.fmt}")
    return w.dequantize()


def mmq_q5_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of K8 (any device)."""
    check_operands(w, b, "q5_k", None)
    return matmul_plain(b.float(), dequantize_q5_k_plain(w), precision)


def _lib():
    return build.load("mmq_q5_k", _SIG)


def _mmq_q5_k_float(w: QuantWeight, b: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """K8 on validated CUDA operands, its plain version on CPU ones."""
    if b.device.type == "cpu":
        return mmq_q5_k_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q5_k runs on cpu or cuda, not {b.device}")
    blocks = w.fields["blocks"]
    if precision == "fast":
        out = launch_tc(_lib().mmq_q5_k_tc_launch, w, b, [(blocks, 16)],
                        "mmq_q5_k", plan=k1_plan)
    else:
        (m, k), n = w.shape, b.shape[0]
        b = b.contiguous()
        if blocks.data_ptr() % 16:
            raise ValueError("Q5_K blocks must be 16-byte aligned")
        out = torch.empty((n, m), dtype=torch.float32, device=b.device)
        if n == 0:
            return out
        err = _lib().mmq_q5_k_launch(
            build.ptr(blocks), build.ptr(b), build.ptr(out), m, n, k,
            int(b.dtype == torch.bfloat16), 0, build.stream_ptr())
        build.check(err, "mmq_q5_k")
    if b.shape[0]:
        mmq_q5_k.launches += 1
    return out


def mmq_q5_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q5_K weights A (M, K) and B (N, K); (N, M) f32."""
    check_precision(precision)
    check_operands(w, b, "q5_k", None)
    if act_quant:
        return route_act_quant(w, b, precision, None, _mmq_q5_k_float)
    return _mmq_q5_k_float(w, b, precision)


mmq_q5_k.launches = 0
