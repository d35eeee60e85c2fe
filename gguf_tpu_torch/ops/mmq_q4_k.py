"""Fused dequantize+matmul for Q4_K weights (kernel K1) and the Q8_1
integer MMQ contract for Q4_K and Q5_K weights (kernel K7), each beside
its plain version.

C = (A @ B.T).T for Q4_K weights A (M, K) and float activations B (N, K):
output (N, M) float32. Counterpart of `gguf_tpu/ops/mmq_q4_k.py:mmq_q4_k`
(its Pallas bodies `_kernel_ink` at decode widths, `_kernel` at prefill
widths, `_kernel_i8` under act_quant); the CUDA sources are
`gguf_tpu_torch/csrc/mmq_q4_k.cu` (K1) and `mmq_i8.cu` (K7).

`precision="fast"` rounds both operands to bf16 before the f32-accumulated
product (the TPU's single-pass bf16 MXU contract); "high" keeps f32.
`glu="silu"|"gelu"` takes the raw fused gate_up output (N, 2K) and uses
h = act(gate) * up, computed in f32 (then rounded to bf16 under "fast"),
as the activation — at every width, one formula.

`act_quant=True` feeds llama.cpp's Q8_1 activations, routed as the JAX
package routes them: under "high" at n <= 16 the codes (K5) go to the
integer contract (K7); otherwise the fake-quantized activations (K6) go
to the float kernel. With `glu`, h is quantized unrounded. The default
is False here, unlike the JAX op's True, so a call without the keyword
keeps bf16 activations; `linear` and `mlp` pass `MMOpts.act_quant`.

On a CPU tensor the wrappers run the plain PyTorch versions; on a CUDA
tensor they launch the kernel or raise. `mmq_q4_k.launches` counts K1
launches and `mmq_i8.launches` K7 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.layouts import BLOCK_BYTES, QK_K, QuantWeight
from . import build
from .activation import GLU_CODES, codes_2d, fake_quant_2d, glu_plain

I8_MAX_N = 16         # the JAX package's n gate for the integer contract
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q4_k_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP]}
_SIG_I8 = {"mmq_i8_launch": [_VP] * 5 + [_I] * 4 + [_VP]}


def check_operands(w: QuantWeight, b: torch.Tensor, fmt: str, glu) -> int:
    """Validate an MMQ call; returns K."""
    if w.fmt != fmt:
        raise ValueError(f"expected a {fmt} weight, got {w.fmt}")
    if glu not in GLU_CODES:
        raise ValueError(f"glu must be one of {list(GLU_CODES)}, got {glu!r}")
    m, k = w.shape
    want = 2 * k if glu else k
    if b.dim() != 2 or b.shape[1] != want:
        raise ValueError(f"activations {tuple(b.shape)} do not match "
                         f"weight {w.shape} (glu={glu})")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {b.dtype}")
    if b.device != w.device:
        raise ValueError(f"weight on {w.device}, activations on {b.device}")
    return k


def check_precision(precision: str) -> None:
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got {precision!r}")


def kquant_parts_plain(w: QuantWeight):
    """Q4_K or Q5_K blocks -> (d*sc, dmin*mn) per 32-block (M, K/256, 8)
    and the codes (M, K/256, 8, 32), all float32, in torch ops on the
    weight's device."""
    m, k = w.shape
    sb = k // QK_K
    blk = w.fields["blocks"].view(m, sb, BLOCK_BYTES[w.fmt])
    d = blk[:, :, 0:2].contiguous().view(torch.float16).float()
    dmin = blk[:, :, 2:4].contiguous().view(torch.float16).float()
    s = blk[:, :, 4:16].int()
    a, bb, c = s[..., 0:4], s[..., 4:8], s[..., 8:12]
    sc = torch.cat([a & 63, (c & 15) | ((a >> 6) << 4)], dim=-1).float()
    mn = torch.cat([bb & 63, (c >> 4) | ((bb >> 6) << 4)], dim=-1).float()
    qs = 48 if w.fmt == "q5_k" else 16
    qv = blk[:, :, qs:].int().view(m, sb, 4, 1, 32)
    q = torch.cat([qv & 15, qv >> 4], dim=3).view(m, sb, 8, 32)
    if w.fmt == "q5_k":     # bit b of qh byte l: fifth bit of block b, elem l
        qh = blk[:, :, 16:48].int().view(m, sb, 1, 32)
        bit = torch.arange(8, dtype=torch.int32, device=qh.device).view(1, 1, 8, 1)
        q = q | (((qh >> bit) & 1) << 4)
    return d * sc, dmin * mn, q.float()


def dequantize_kquant_plain(w: QuantWeight) -> torch.Tensor:
    """(M, K) float32 from Q4_K or Q5_K bytes; same float op order as
    `gguf_tpu.quant.dequantize_q4_k` / `dequantize_q5_k`
    (x = (d*sc)*q - dmin*mn), so bit-equal to them."""
    scale, minv, q = kquant_parts_plain(w)
    return (scale[..., None] * q - minv[..., None]).view(w.shape)


def dequantize_q4_k_plain(w: QuantWeight) -> torch.Tensor:
    if w.fmt != "q4_k":
        raise ValueError(f"expected a q4_k weight, got {w.fmt}")
    return dequantize_kquant_plain(w)


def matmul_plain(x: torch.Tensor, wf: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """x (N, K) f32 @ wf (M, K)^T with the kernels' rounding contract."""
    if precision == "fast":
        x = x.bfloat16().float()
        wf = wf.bfloat16().float()
    return x @ wf.T


def mmq_q4_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high", glu: str | None = None
                   ) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device)."""
    check_operands(w, b, "q4_k", glu)
    x = glu_plain(b, glu) if glu else b.float()
    return matmul_plain(x, dequantize_q4_k_plain(w), precision)


def _lib():
    return build.load("mmq_q4_k", _SIG)


def _mmq_q4_k_float(w: QuantWeight, b: torch.Tensor, precision: str,
                    glu: str | None = None) -> torch.Tensor:
    """K1 on validated CUDA operands, its plain version on CPU ones."""
    if b.device.type == "cpu":
        return mmq_q4_k_plain(w, b, precision=precision, glu=glu)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q4_k runs on cpu or cuda, not {b.device}")
    (m, k), n = w.shape, b.shape[0]
    b = b.contiguous()
    blocks = w.fields["blocks"]
    if blocks.data_ptr() % 16:
        raise ValueError("Q4_K blocks must be 16-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=b.device)
    if n == 0:
        return out
    err = _lib().mmq_q4_k_launch(
        build.ptr(blocks), build.ptr(b), build.ptr(out), m, n, k,
        b.shape[1], int(b.dtype == torch.bfloat16), GLU_CODES[glu],
        int(precision == "fast"), build.stream_ptr())
    build.check(err, "mmq_q4_k")
    mmq_q4_k.launches += 1
    return out


def route_act_quant(w: QuantWeight, b: torch.Tensor, precision: str,
                    glu: str | None, float_fn) -> torch.Tensor:
    """llama.cpp's Q8_1 activations for validated Q4_K/Q5_K operands,
    routed as the JAX package routes them: under "high" at n <= 16 the
    codes (K5) go to the integer contract (K7); otherwise the
    fake-quantized activations (K6) go to `float_fn(w, b, precision)`,
    the format's float kernel. With `glu`, h = act(gate) * up is quantized
    unrounded."""
    k = w.shape[1]
    if precision == "high" and b.shape[0] <= I8_MAX_N:
        return _mmq_i8(w, *codes_2d(b, k, glu))
    return float_fn(w, fake_quant_2d(b, k, glu), precision)


def mmq_q4_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             glu: str | None = None, act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q4_K weights A (M, K) and B (N, K) [(N, 2K)
    with `glu`]; returns (N, M) float32."""
    check_precision(precision)
    check_operands(w, b, "q4_k", glu)
    if act_quant:
        return route_act_quant(w, b, precision, glu, _mmq_q4_k_float)
    return _mmq_q4_k_float(w, b, precision, glu)


mmq_q4_k.launches = 0


# ------------------------------------------------- K7: Q8_1 integer MMQ ---


def _check_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
              s: torch.Tensor) -> int:
    if w.fmt not in ("q4_k", "q5_k"):
        raise ValueError(f"mmq_i8 takes q4_k or q5_k weights, got {w.fmt}")
    m, k = w.shape
    n = q.shape[0]
    if q.dtype != torch.int8 or q.shape != (n, k):
        raise ValueError(f"codes must be int8 ({n}, {k}), got "
                         f"{q.dtype} {tuple(q.shape)}")
    for t in (d, s):
        if t.dtype != torch.float32 or t.shape != (n, k // 32):
            raise ValueError(f"d and s must be float32 ({n}, {k // 32})")
    if any(t.device != w.device for t in (q, d, s)):
        raise ValueError("weight, codes and scales must share a device")
    return n


def mmq_i8_plain(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (any device, any n). The per-32-block
    partials come from an f32 batched matmul, exact because
    |partial| <= 32 * 127 * 31 < 2^24 (TF32 must be off on a GPU)."""
    n = _check_i8(w, q, d, s)
    m, k = w.shape
    nb = k // 32
    scale, minv, codes = kquant_parts_plain(w)
    p = torch.bmm(q.float().view(n, nb, 32).transpose(0, 1),
                  codes.view(m, nb, 32).permute(1, 2, 0))       # (nb, n, M)
    c = ((p * d.T[:, :, None]) * scale.view(m, nb).T[:, None, :]).sum(dim=0)
    return c - s @ minv.view(m, nb).T


def _lib_i8():
    return build.load("mmq_i8", _SIG_I8)


def mmq_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """llama.cpp's integer MMQ: Q4_K/Q5_K weights (M, K) x Q8_1 activation
    codes q (n, K) int8 with their d and s (n, K/32) f32, n <= 16;
    returns (n, M) float32."""
    n = _check_i8(w, q, d, s)
    if q.device.type == "cuda" and n > I8_MAX_N:
        raise ValueError(f"mmq_i8 takes at most {I8_MAX_N} activation rows, "
                         f"got {n}")
    return _mmq_i8(w, q, d, s)


def _mmq_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """K7 on validated CUDA operands (n <= 16), its plain version on CPU
    ones."""
    if q.device.type == "cpu":
        return mmq_i8_plain(w, q, d, s)
    if q.device.type != "cuda":
        raise ValueError(f"mmq_i8 runs on cpu or cuda, not {q.device}")
    (m, k), n = w.shape, q.shape[0]
    q, d, s = q.contiguous(), d.contiguous(), s.contiguous()
    blocks = w.fields["blocks"]
    if blocks.data_ptr() % 16 or q.data_ptr() % 8:
        raise ValueError("mmq_i8: weight blocks must be 16-byte and codes "
                         "8-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    err = _lib_i8().mmq_i8_launch(
        build.ptr(blocks), build.ptr(q), build.ptr(d), build.ptr(s),
        build.ptr(out), m, n, k, int(w.fmt == "q5_k"), build.stream_ptr())
    build.check(err, "mmq_i8")
    mmq_i8.launches += 1
    return out


mmq_i8.launches = 0
