"""Fused dequantize+matmul for Q2_K weights: kernel K12 and its plain version.

C = (A @ B.T).T for Q2_K weights A (M, K), K a multiple of 256, and float
activations B (N, K): output (N, M) float32. The element value is
(d*sc)*q - dmin*mn per 16-element sub-block, q a 2-bit code.

The reference computes the product in one of two arms, chosen by the
call's width n through n_pad = max(8, round_up(n, 8)) <= 64 (its decode
arm, `INK_GLUE_MAX_N`), and under "fast" they differ by whole bf16 ulps,
so the port keeps both:

    split  (n <= 64):  C = b . (d*sc*q)^T  -  bsum16 . (dmin*mn)^T
    folded (n > 64):   C = b . (d*sc*q - dmin*mn)^T

where under "fast" b and the staged weight are rounded to bf16 (f32 under
"high") with f32 accumulation, and bsum16 holds the per-16 sums of the
activations AS ROUNDED (bf16 under "fast"), taken in f32; the min term is
f32. `act_quant=True` fake-quantizes the activations to Q8_1 first (K6) at
any width and in both precisions, then takes the same arm; there is no
integer contract for Q2_K in the reference and no fp16 rounding of the
sums. Counterpart of `gguf_tpu/ops/mmq_q2_k.py:mmq_q2_k` (Pallas
`_kernel`; its plane order and activation permutes are TPU glue); the CUDA
source is `gguf_tpu_torch/csrc/mmq_q2_k.cu`. "fast" runs its bf16
tensor-core tile, whose tile width decides the arm (one warpgroup, n <=
64: split; two, n > 64: folded, `tc_tile`); "high" runs its SIMT f32 tile.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K12 or raises. `mmq_q2_k.launches` counts K12 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import QuantWeight, q2_k_parts
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, launch_tc, matmul_plain
from .mmq_q8_0 import launch_split_k

SPLIT_MAX_N = 64      # the reference's INK_GLUE_MAX_N on n_pad
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q2_k_launch": [_VP] * 7 + [_I] * 8 + [_VP],
        "mmq_q2_k_tc_launch": [_VP] * 8 + [_I] * 6 + [_VP]}


def split_arm(n: int) -> bool:
    """Whether the reference takes its split arm at width n."""
    return max(8, -(-n // 8) * 8) <= SPLIT_MAX_N


def mmq_q2_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high",
                   split: bool | None = None) -> torch.Tensor:
    """Plain PyTorch version of K12 (any device); `split` forces an arm
    (default: the reference's choice for this width)."""
    check_operands(w, b, "q2_k", None)
    (m, k), n = w.shape, b.shape[0]
    x = b.float()
    if not (split_arm(n) if split is None else split):
        return matmul_plain(x, w.dequantize(), precision)
    scale16, min16, q = q2_k_parts(w)
    main = matmul_plain(x, (scale16[..., None] * q).view(m, k), precision)
    xs = x.bfloat16().float() if precision == "fast" else x
    bsum16 = xs.view(n, k // 16, 16).sum(dim=-1)
    return main - bsum16 @ min16.view(m, k // 16).T


def _lib():
    return build.load("mmq_q2_k", _SIG)


def mmq_q2_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q2_K weights A (M, K) and B (N, K); (N, M) f32."""
    check_precision(precision)
    k = check_operands(w, b, "q2_k", None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_q2_k_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q2_k runs on cpu or cuda, not {b.device}")
    f = w.fields
    fields = [(f["sc"], 8), (f["qs"], 16), (f["d"], 2), (f["dmin"], 2)]
    if precision == "fast":
        out = launch_tc(_lib().mmq_q2_k_tc_launch, w, b, fields, "mmq_q2_k")
    else:
        out = launch_split_k(_lib().mmq_q2_k_launch, w, b, fields,
                             (int(split_arm(b.shape[0])),), precision,
                             "mmq_q2_k")
    if b.shape[0]:
        mmq_q2_k.launches += 1
    return out


mmq_q2_k.launches = 0
