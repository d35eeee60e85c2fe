"""Fused dequantize+matmul for Q3_K weights: kernel K13 and its plain version.

C = (A @ B.T).T for Q3_K weights A (M, K), K a multiple of 256, and float
activations B (N, K): output (N, M) float32. The element value is
(d*sc) * (q - 4), q = low2 | hbit << 2 a 3-bit code and sc the signed
6-bit scale of its 16-element sub-block: exact in f32, so it equals the
reference's q*s - 4*s and both of its width arms compute the same
numbers. "high" keeps f32 operands; "fast" rounds both w and the
activations to bf16 before the f32-accumulated product. `act_quant=True`
fake-quantizes the activations to Q8_1 first (K6) at any width and in
both precisions, as the JAX package does (default False, see `mmq_q4_k`);
there is no integer contract for Q3_K in the reference. Counterpart of
`gguf_tpu/ops/mmq_q3_k.py:mmq_q3_k` (Pallas `_kernel`; its plane order and
activation permutes are TPU glue); the CUDA source is
`gguf_tpu_torch/csrc/mmq_q3_k.cu`: "fast" runs its bf16 tensor-core tile
(128-element chunks, split as `tc_plan` says), "high" its SIMT f32 tile.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K13 or raises. `mmq_q3_k.launches` counts K13 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import QuantWeight
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, launch_tc, matmul_plain
from .mmq_q8_0 import launch_split_k

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q3_k_launch": [_VP] * 7 + [_I] * 7 + [_VP],
        "mmq_q3_k_tc_launch": [_VP] * 8 + [_I] * 6 + [_VP]}


def mmq_q3_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of K13 (any device)."""
    check_operands(w, b, "q3_k", None)
    return matmul_plain(b.float(), w.dequantize(), precision)


def _lib():
    return build.load("mmq_q3_k", _SIG)


def mmq_q3_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q3_K weights A (M, K) and B (N, K); (N, M) f32."""
    check_precision(precision)
    k = check_operands(w, b, "q3_k", None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_q3_k_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q3_k runs on cpu or cuda, not {b.device}")
    return _launch(w, b, precision)


def _launch(w: QuantWeight, b: torch.Tensor, precision: str) -> torch.Tensor:
    """K13 on validated CUDA operands: the tensor-core tile under "fast",
    the SIMT tile under "high"."""
    f = w.fields
    if precision == "fast":
        # hmask and qs are TMA boxes; the 12 scale bytes three 4-byte loads
        out = launch_tc(_lib().mmq_q3_k_tc_launch, w, b,
                        [(f["hmask"], 16), (f["qs"], 16), (f["scales"], 4),
                         (f["d"], 2)], "mmq_q3_k")
    else:
        out = launch_split_k(
            _lib().mmq_q3_k_launch, w, b,
            [(f["hmask"], 8), (f["qs"], 8), (f["scales"], 1), (f["d"], 2)],
            (), precision, "mmq_q3_k")
    if b.shape[0]:
        mmq_q3_k.launches += 1
    return out


mmq_q3_k.launches = 0
