"""Fused dequantize+matmul for the IQ4 codebook formats IQ4_NL and IQ4_XS:
kernel K14 and its plain version.

C = (A @ B.T).T for weights A (M, K), K a multiple of 256, and float
activations B (N, K): output (N, M) float32. Each 4-bit code indexes the
16-entry IQ4 codebook (`quant/iq4.py:KVALUES`); the element value is d*KV[q]
(IQ4_NL, an fp16 d per 32-block) or (d*ls)*KV[q] (IQ4_XS, an fp16 d per
256-superblock times a signed 6-bit scale per 32), exact in f32. Both
formats are symmetric, so there is no correction term. "high" keeps f32
operands; "fast" rounds both w and the activations to bf16 before the
f32-accumulated product. `act_quant=True` fake-quantizes the activations
to Q8_1 first (K6) at any width, as the JAX package does (default False,
see `mmq_q4_k`). Counterpart of `gguf_tpu/ops/mmq_iq4.py` (`mmq_iq4_nl`,
`mmq_iq4_xs`, Pallas `_kernel`); the CUDA source is
`gguf_tpu_torch/csrc/mmq_iq4.cu` over the tile in `csrc/block32.cuh`.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch K14 or raise. `mmq_iq4.launches` counts K14 launches,
whichever of the two wrappers made them.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import QuantWeight
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, matmul_plain
from .mmq_q8_0 import format_wrapper, launch_split_k

IQ4 = ("iq4_nl", "iq4_xs")
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_iq4_launch": [_VP] * 7 + [_I] * 8 + [_VP]}


def mmq_iq4_plain(w: QuantWeight, b: torch.Tensor, *,
                  precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of K14 (any device)."""
    if w.fmt not in IQ4:
        raise ValueError(f"expected one of {IQ4}, got {w.fmt}")
    check_operands(w, b, w.fmt, None)
    return matmul_plain(b.float(), w.dequantize(), precision)


def _lib():
    return build.load("mmq_iq4", _SIG)


def mmq_iq4(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
            act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for IQ4_NL or IQ4_XS weights A (M, K) and B (N, K);
    (N, M) f32."""
    check_precision(precision)
    if w.fmt not in IQ4:
        raise ValueError(f"mmq_iq4 takes {IQ4}, got {w.fmt}")
    k = check_operands(w, b, w.fmt, None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_iq4_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_iq4 runs on cpu or cuda, not {b.device}")
    f = w.fields
    out = launch_split_k(
        _lib().mmq_iq4_launch, w, b,
        [(f["d"], 2), (f.get("scales_h"), 2), (f.get("scales_l"), 1),
         (f["qs"], 16)], (int(w.fmt == "iq4_xs"),), precision, "mmq_iq4")
    if b.shape[0]:
        mmq_iq4.launches += 1
    return out


mmq_iq4.launches = 0


mmq_iq4_nl = format_wrapper(mmq_iq4, "iq4_nl", "K14")
mmq_iq4_xs = format_wrapper(mmq_iq4, "iq4_xs", "K14")
