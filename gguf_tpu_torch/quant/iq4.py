"""IQ4_NL and IQ4_XS quantizers: 4-bit codes into a fixed 16-entry
codebook of int8 values (`KVALUES`, ggml's kvalues_iq4nl).

The port's own copy of the quantizers of `gguf_tpu/quant/iq4.py` (GGML's
quantize_row_iq4_nl / _xs without an importance matrix, as vectorized
numpy): the same candidate-scale search, weighted least-squares refit and
6-bit scale packing, so the bytes are identical. The port dequantizes in
torch (`quant/layouts.py`), so no parser is kept here.

Block layouts (little-endian):
  iq4_nl: 32 elems / 18 bytes  [d fp16][qs 16B]
          x_j = d * KVALUES[q_j]; byte j holds elem j (lo) | elem j+16 (hi)
  iq4_xs: 256 elems / 136 bytes [d fp16][scales_h u16][scales_l 4B][qs 128B]
          8 sub-blocks of 32; sub-block ib has a 6-bit scale
          ls = (scales_l nibble ib) | ((scales_h >> 2*ib) & 3) << 4,
          x = d * (ls - 32) * KVALUES[q]; qs 16 bytes per sub-block with
          the same lo/hi split as iq4_nl.
"""

from __future__ import annotations

import numpy as np

BLOCK_NL = 32
BLOCK_BYTES_NL = 18
QK_K = 256
BLOCK_BYTES_XS = 136

KVALUES = np.array([-127, -104, -83, -65, -49, -35, -22, -10,
                    1, 13, 25, 38, 53, 69, 89, 113], dtype=np.int8)
# nearest-value decision boundaries; ties round toward the upper index,
# matching ggml best_index_int8 (x - lo < hi - x ? lo : hi)
_MIDS = (KVALUES[:-1].astype(np.float32) + KVALUES[1:]) / 2.0

_EPS = 1e-15  # GROUP_MAX_EPS


def best_index(x: np.ndarray) -> np.ndarray:
    """Index of the KVALUES entry nearest to each float (ties upward)."""
    return np.searchsorted(_MIDS, x, side="right").astype(np.uint8)


def _signed_absmax(g: np.ndarray) -> np.ndarray:
    """Per-row value with the largest |x| (first occurrence, keeping sign)."""
    idx = np.argmax(np.abs(g), axis=1)
    return g[np.arange(g.shape[0]), idx]


def _fit_scales(g: np.ndarray) -> np.ndarray:
    """GGML's per-32 candidate-scale search (quantize_row_iq4_nl_impl,
    ntry=7, weights x^2): candidates are the sign-preserving absmax fit
    id = 127/max plus id = (t-127)/max for t in [-7, 7]; each candidate's
    codes are refit by weighted least squares d = sum(w q x)/sum(w q^2),
    and the best sum(w q x)^2/sum(w q^2) wins (first candidate on ties).
    Returns (nb,) f32 scales; zero rows get 0."""
    nb = g.shape[0]
    w = g * g
    mx = _signed_absmax(g)
    amax = np.abs(mx)
    safe_mx = np.where(amax < _EPS, 1.0, mx)

    ids = np.empty((16, nb), np.float32)
    ids[0] = 127.0 / safe_mx                    # initial d = -max/values[0]
    for i, t in enumerate(range(-7, 8)):
        ids[i + 1] = (t - 127.0) / safe_mx
    # (cand, nb, 32) candidate codes -> codebook values
    q = KVALUES[best_index(ids[:, :, None] * g[None, :, :])].astype(np.float32)
    sumqx = np.einsum("nk,cnk->cn", w * g, q)
    sumq2 = np.einsum("nk,cnk->cn", w, q * q)
    score = np.where(sumq2 > 0, sumqx * sumqx / np.where(sumq2 == 0, 1, sumq2),
                     -np.inf)
    best = np.argmax(score, axis=0)             # first max wins ties
    rows = np.arange(nb)
    d = sumqx[best, rows] / np.where(sumq2[best, rows] == 0, 1,
                                     sumq2[best, rows])
    return np.where(amax < _EPS, 0.0, d).astype(np.float32)


def _chunked(fn, x: np.ndarray, rows_per_chunk: int = 65536) -> np.ndarray:
    if x.shape[0] <= rows_per_chunk:
        return fn(x)
    return np.concatenate([fn(x[i:i + rows_per_chunk])
                           for i in range(0, x.shape[0], rows_per_chunk)])


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    """Float array (size % 32 == 0) -> flat IQ4_NL block bytes (uint8)."""
    g = np.asarray(x, dtype=np.float32).reshape(-1)
    if g.size % BLOCK_NL:
        raise ValueError(f"iq4_nl needs size % {BLOCK_NL} == 0, got {g.size}")
    g = g.reshape(-1, BLOCK_NL)

    def one(gc):
        df = np.asarray(_fit_scales(gc), np.float32)
        inv = np.where(df != 0, 1.0 / np.where(df == 0, 1, df), 0.0)
        codes = best_index(inv[:, None] * gc)
        out = np.empty((df.shape[0], BLOCK_BYTES_NL), np.uint8)
        out[:, :2] = df.astype(np.float16)[:, None].view(np.uint8)
        out[:, 2:] = codes[:, :16] | (codes[:, 16:] << 4)
        return out

    return _chunked(one, g).reshape(-1)


def quantize_iq4_xs(x: np.ndarray) -> np.ndarray:
    """Float array (size % 256 == 0) -> flat IQ4_XS superblock bytes."""
    g = np.asarray(x, dtype=np.float32).reshape(-1)
    if g.size % QK_K:
        raise ValueError(f"iq4_xs needs size % {QK_K} == 0, got {g.size}")
    g = g.reshape(-1, QK_K)

    def one(gc):
        ns = gc.shape[0]
        sub = gc.reshape(ns * 8, BLOCK_NL)
        scales = _fit_scales(sub).reshape(ns, 8)
        mx = _signed_absmax(scales)             # max_scale, sign kept
        d = np.where(np.abs(mx) > 0, -mx / 32.0, 0.0).astype(np.float32)
        inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        ls = np.clip(np.rint(inv_d[:, None] * scales), -32, 31)  # 6-bit
        dl = d[:, None] * ls                    # effective per-sub-block scale
        inv_dl = np.where(dl != 0, 1.0 / np.where(dl == 0, 1, dl), 0.0)
        codes = best_index(inv_dl.reshape(-1)[:, None] * sub)    # (ns*8, 32)
        lsu = (ls + 32).astype(np.uint16)       # [0, 64)

        out = np.empty((ns, BLOCK_BYTES_XS), np.uint8)
        out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
        sh = np.zeros(ns, np.uint16)
        for ib in range(8):
            sh |= ((lsu[:, ib] >> 4) << (2 * ib)).astype(np.uint16)
        out[:, 2:4] = sh[:, None].view(np.uint8)
        lo = lsu & 0xF
        for i in range(4):
            out[:, 4 + i] = (lo[:, 2 * i] | (lo[:, 2 * i + 1] << 4)).astype(np.uint8)
        c = codes.reshape(ns, 8, BLOCK_NL)
        out[:, 8:] = (c[:, :, :16] | (c[:, :, 16:] << 4)).reshape(ns, 128)
        return out

    return _chunked(one, g, 8192).reshape(-1)
