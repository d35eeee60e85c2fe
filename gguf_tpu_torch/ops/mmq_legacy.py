"""Fused dequantize+matmul for the legacy 32-element-block formats Q4_0,
Q4_1, Q5_0 and Q5_1: kernel K11 and its plain version.

C = (A @ B.T).T for weights A (M, K), K a multiple of 256, and float
activations B (N, K): output (N, M) float32. Counterpart of
`gguf_tpu/ops/mmq_legacy.py` (`mmq_q4_0` .. `mmq_q5_1`, Pallas `_kernel`);
the CUDA source is `gguf_tpu_torch/csrc/mmq_legacy.cu`: "fast" runs its
bf16 tensor-core tile (`csrc/block32_tc.cuh`, a policy per format,
128-element chunks, split as `tc_plan` says), "high" the SIMT f32 tile of
`csrc/block32.cuh` shared with K10 (`mmq_q8_0`) and K14.

The product is split as the reference splits it, which under "fast" is
not dequantize-then-matmul: with q the raw 4- or 5-bit code (before the
-8 or -16 offset),

    C = b . (d*q)^T  +  bsum . corr^T

where the main term takes bf16-rounded b and d*q under "fast" (f32
under "high") with f32 accumulation, `bsum` holds the per-32 sums of the
UNROUNDED f32 activations, and `corr` is m for the `_1` formats and
-off*d for the `_0` formats; the correction is f32. Rounding d*(q-8) to
bf16 instead would differ by whole bf16 ulps under cancellation.

`act_quant=True` fake-quantizes the activations to Q8_1 first (K6) at any
width and in both precisions, and rounds the block sums through fp16
(Q8_1's `s` field), as the JAX package does; there is no integer
contract for these formats in the reference. Under act_quant every sum
is d8 times an integer below 2^12, exact in f32 in any order, so that
fp16 rounding does not depend on the summation order.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch K11 or raise. `mmq_legacy.launches` counts K11
launches, whichever of the four wrappers made them.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import LEGACY, QuantWeight, legacy_offset, legacy_parts
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, launch_tc, matmul_plain
from .mmq_q8_0 import format_wrapper, launch_split_k

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_legacy_launch": [_VP] * 7 + [_I] * 9 + [_VP],
        "mmq_legacy_tc_launch": [_VP] * 9 + [_I] * 8 + [_VP]}
FMT_CODES = {"q4_0": 1, "q4_1": 2, "q5_0": 3, "q5_1": 4}   # csrc/block32.cuh


def mmq_legacy_plain(w: QuantWeight, b: torch.Tensor, *,
                     precision: str = "high",
                     fp16_bsum: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K11 (any device): the reference's split
    product. `fp16_bsum` rounds the block sums through fp16 (the
    act_quant contract)."""
    if w.fmt not in LEGACY:
        raise ValueError(f"expected one of {LEGACY}, got {w.fmt}")
    check_operands(w, b, w.fmt, None)
    (m, k), n = w.shape, b.shape[0]
    d, mn, q = legacy_parts(w)
    x = b.float()
    main = matmul_plain(x, (d[..., None] * q).view(m, k), precision)
    bsum = x.view(n, k // 32, 32).sum(dim=-1)
    if fp16_bsum:
        bsum = bsum.half().float()
    corr = mn if mn is not None else d * -legacy_offset(w.fmt)
    return main + bsum @ corr.T


def _lib():
    return build.load("mmq_legacy", _SIG)


def mmq_legacy(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
               act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q4_0/Q4_1/Q5_0/Q5_1 weights A (M, K) and B
    (N, K); (N, M) f32."""
    check_precision(precision)
    if w.fmt not in LEGACY:
        raise ValueError(f"mmq_legacy takes {LEGACY}, got {w.fmt}")
    k = check_operands(w, b, w.fmt, None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_legacy_plain(w, b, precision=precision,
                                fp16_bsum=act_quant)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_legacy runs on cpu or cuda, not {b.device}")
    return _launch(w, b, precision, act_quant)


def _launch(w: QuantWeight, b: torch.Tensor, precision: str,
            fp16_bsum: bool) -> torch.Tensor:
    """K11 on validated CUDA operands: the tensor-core tile under "fast"
    (its block sums from the staged bf16 tile, or from the pass that
    rounds an f32 operand), the SIMT tile under "high"."""
    f = w.fields
    codes = (FMT_CODES[w.fmt], int(fp16_bsum))
    if precision == "fast":
        # a chunk's four d (or m) are one 8-byte load, its four qh 16 bytes
        out = launch_tc(_lib().mmq_legacy_tc_launch, w, b,
                        [(f["d"], 8), (f.get("m"), 8), (f.get("qh"), 16),
                         (f["qs"], 16)], "mmq_legacy", extra=codes,
                        bsum=True)
    else:
        out = launch_split_k(
            _lib().mmq_legacy_launch, w, b,
            [(f["d"], 2), (f.get("m"), 2), (f.get("qh"), 4), (f["qs"], 16)],
            codes, precision, "mmq_legacy")
    if b.shape[0]:
        mmq_legacy.launches += 1
    return out


mmq_legacy.launches = 0


mmq_q4_0 = format_wrapper(mmq_legacy, "q4_0", "K11")
mmq_q4_1 = format_wrapper(mmq_legacy, "q4_1", "K11")
mmq_q5_0 = format_wrapper(mmq_legacy, "q5_0", "K11")
mmq_q5_1 = format_wrapper(mmq_legacy, "q5_1", "K11")
