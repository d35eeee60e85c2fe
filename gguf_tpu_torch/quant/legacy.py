"""Legacy GGUF quantizers — Q4_0, Q4_1, Q5_0, Q5_1 (32-element blocks).

The port's own copy of the quantizers of `gguf_tpu/quant/legacy.py`:
GGML's reference quantizers (ggml-quants.c) as vectorized numpy, with the
same truncation-based rounding and fp16 scale storage. The port
dequantizes in torch (`QuantWeight.dequantize`).

Block layouts (all little-endian; byte j of qs holds element j in its low
nibble and element j+16 in its high nibble):
  q4_0: [d fp16][qs 16B]                 x = d * (q - 8),   q in [0, 16)
  q4_1: [d fp16][m fp16][qs 16B]         x = d * q + m,     q in [0, 16)
  q5_0: [d fp16][qh 4B][qs 16B]          x = d * (q - 16),  q in [0, 32)
  q5_1: [d fp16][m fp16][qh 4B][qs 16B]  x = d * q + m
qh is a little-endian u32 whose bit j is element j's fifth bit.
"""

from __future__ import annotations

import numpy as np

BLOCK = 32
BLOCK_BYTES = {"q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24}


def _signed_absmax(g: np.ndarray) -> np.ndarray:
    """Per-row value with the largest |x| (first occurrence wins, keeping its
    sign) — GGML's `if (amax < fabsf(v)) { amax = |v|; max = v; }` loop."""
    idx = np.argmax(np.abs(g), axis=1)
    return g[np.arange(g.shape[0]), idx]


def _blocks(x: np.ndarray, fmt: str) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if x.size % BLOCK:
        raise ValueError(f"{fmt} needs size % {BLOCK} == 0, got {x.size}")
    return x.reshape(-1, BLOCK)


def _pack_qh(hi: np.ndarray) -> np.ndarray:
    """(nb, 32) 0/1 fifth bits -> (nb, 4) qh bytes (u32 little-endian,
    bit j = elem j)."""
    w = np.zeros(hi.shape[0], np.uint32)
    for j in range(32):
        w |= hi[:, j].astype(np.uint32) << j
    return w[:, None].view(np.uint8).reshape(-1, 4)


def _codes_scale(g: np.ndarray, neg_max_div: float, qmax: int):
    """GGML symmetric quantizer: d = signed_max / -neg_max_div, codes =
    min(qmax, trunc(x/d + (qmax+1)/2 + .5)). The +.5 truncation equals
    round-half-up because x/d + offset >= 0.5 by construction."""
    mx = _signed_absmax(g)
    d = mx / np.float32(-neg_max_div)
    inv = np.where(d != 0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0)
    off = np.float32((qmax + 1) / 2 + 0.5)
    q = np.minimum(qmax, np.trunc(g * inv[:, None] + off)).astype(np.uint8)
    return q, d.astype(np.float16)


def _codes_affine(g: np.ndarray, qmax: int):
    """GGML affine quantizer: d = (max-min)/qmax, codes =
    min(qmax, trunc((x-min)/d + .5))."""
    mn = g.min(axis=1)
    d = (g.max(axis=1) - mn) / np.float32(qmax)
    inv = np.where(d != 0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(qmax, np.trunc((g - mn[:, None]) * inv[:, None]
                                  + np.float32(0.5))).astype(np.uint8)
    return q, d.astype(np.float16), mn.astype(np.float16)


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(nb, 32) low-nibble codes -> (nb, 16) on-disk bytes (j | j+16 << 4)."""
    return ((q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)).astype(np.uint8)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    g = _blocks(x, "q4_0")
    q, d = _codes_scale(g, 8.0, 15)
    out = np.empty((g.shape[0], 18), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = _pack_nibbles(q)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    g = _blocks(x, "q4_1")
    q, d, mn = _codes_affine(g, 15)
    out = np.empty((g.shape[0], 20), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.view(np.uint8).reshape(-1, 2)
    out[:, 4:] = _pack_nibbles(q)
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    g = _blocks(x, "q5_0")
    q, d = _codes_scale(g, 16.0, 31)
    out = np.empty((g.shape[0], 22), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = _pack_qh(q >> 4)
    out[:, 6:] = _pack_nibbles(q)
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    g = _blocks(x, "q5_1")
    q, d, mn = _codes_affine(g, 31)
    out = np.empty((g.shape[0], 24), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = _pack_qh(q >> 4)
    out[:, 8:] = _pack_nibbles(q)
    return out.reshape(-1)
