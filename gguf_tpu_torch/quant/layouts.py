"""Quantized weights on the device: GGUF block bytes as stored, and their
dequantization in torch.

`QuantWeight` is the port's counterpart of `gguf_tpu.quant.layouts
.QuantTensor`. The TPU package re-lays every matrix into K-major
structure-of-arrays "planes" so each field is a 128-lane tile; a CUDA
kernel reads GGUF bytes directly, so the port keeps them as stored: rows
of the (M, K) matrix are runs of blocks, one row per output feature.

Q4_K's 144-byte and Q5_K's 176-byte superblocks are 16-byte aligned and
stay whole (field "blocks", (M, K/256*bytes) uint8). The other blocks are
not 4-byte aligned (Q2_K 84 bytes, Q3_K 110, Q6_K 210, IQ4_XS 136; Q8_0
34; Q4_0 and IQ4_NL 18, Q4_1 20, Q5_0 22, Q5_1 24), so they are split at
load into per-field arrays, each a (M, K/block*field_bytes) uint8 tensor
whose rows keep the GGUF byte order (`FIELDS`), so that a kernel thread
reads its codes in wide aligned loads; `blocks()` reassembles the exact
file bytes.

`dequantize()` runs in torch on the weight's own device, with the float
ops of `QuantTensor.dequantize()` in the same order, so bit-equal to it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .iq4 import KVALUES

QK_K = 256
QK = 32
BLOCK_BYTES = {"q2_k": 84, "q3_k": 110, "q4_k": 144, "q5_k": 176,
               "q6_k": 210, "q8_0": 34, "q4_0": 18, "q4_1": 20, "q5_0": 22,
               "q5_1": 24, "iq4_nl": 18, "iq4_xs": 136}
BLOCK_ELEMS = {**{f: QK_K for f in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
                                    "iq4_xs")},
               **{f: QK for f in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1",
                                  "iq4_nl")}}
LEGACY = ("q4_0", "q4_1", "q5_0", "q5_1")
# the K a format's MMQ takes: Q8_0 any multiple of 32; the legacy formats
# and IQ4_NL multiples of 256, as the JAX package's `mmq_legacy` and
# `mmq_iq4_nl` demand
K_MULTIPLE = {**BLOCK_ELEMS, **{f: QK_K for f in (*LEGACY, "iq4_nl")}}
# (field, first byte, end byte) of one block of each split format
FIELDS = {
    "q2_k": (("sc", 0, 16), ("qs", 16, 80), ("d", 80, 82),
             ("dmin", 82, 84)),
    "q3_k": (("hmask", 0, 32), ("qs", 32, 96), ("scales", 96, 108),
             ("d", 108, 110)),
    "q6_k": (("ql", 0, 128), ("qh", 128, 192), ("sc", 192, 208),
             ("d", 208, 210)),
    "q8_0": (("d", 0, 2), ("qs", 2, 34)),
    "q4_0": (("d", 0, 2), ("qs", 2, 18)),
    "q4_1": (("d", 0, 2), ("m", 2, 4), ("qs", 4, 20)),
    "q5_0": (("d", 0, 2), ("qh", 2, 6), ("qs", 6, 22)),
    "q5_1": (("d", 0, 2), ("m", 2, 4), ("qh", 4, 8), ("qs", 8, 24)),
    "iq4_nl": (("d", 0, 2), ("qs", 2, 18)),
    "iq4_xs": (("d", 0, 2), ("scales_h", 2, 4), ("scales_l", 4, 8),
               ("qs", 8, 136)),
}


@dataclass
class QuantWeight:
    """A quantized (M, K) matrix: GGUF block bytes on `device`."""

    fmt: str
    shape: tuple
    fields: dict

    @classmethod
    def from_blocks(cls, fmt: str, blocks, shape, device) -> "QuantWeight":
        """GGUF bytes of an (M, K) tensor (any array-like of uint8) ->
        QuantWeight on `device`."""
        if fmt not in BLOCK_BYTES:
            raise NotImplementedError(
                f"{fmt} weights are not supported: the port reads "
                f"{sorted(BLOCK_BYTES)}")
        m, k = shape
        if k % K_MULTIPLE[fmt]:
            raise ValueError(f"{fmt}: K must be a multiple of "
                             f"{K_MULTIPLE[fmt]}, got {k}")
        nb = k // BLOCK_ELEMS[fmt]
        raw = np.asarray(blocks, dtype=np.uint8).reshape(m, nb * BLOCK_BYTES[fmt])
        t = torch.from_numpy(raw.copy())
        if fmt in FIELDS:
            per = t.view(m, nb, BLOCK_BYTES[fmt])
            fields = {name: per[:, :, lo:hi].reshape(m, -1).contiguous()
                      .to(device) for name, lo, hi in FIELDS[fmt]}
        else:
            fields = {"blocks": t.to(device)}
        return cls(fmt, (m, k), fields)

    @property
    def device(self) -> torch.device:
        return next(iter(self.fields.values())).device

    def blocks(self) -> torch.Tensor:
        """(M, K/block*bytes) uint8: the tensor's GGUF bytes, on its device."""
        if self.fmt in FIELDS:
            m, nb = self.shape[0], self.shape[1] // BLOCK_ELEMS[self.fmt]
            return torch.cat([self.fields[n].view(m, nb, -1)
                              for n, _, _ in FIELDS[self.fmt]],
                             dim=2).view(m, -1)
        return self.fields["blocks"]

    def dequantize(self) -> torch.Tensor:
        """(M, K) float32 on the weight's device, bit-equal to the JAX
        package's `QuantTensor.dequantize()`."""
        return _DEQUANT[self.fmt](self)

    def row_block(self, lo: int, hi: int) -> "QuantWeight":
        """Output rows lo..hi-1 as views of the fields, no copy: one
        expert of a stack of experts (each field stays contiguous)."""
        return QuantWeight(self.fmt, (hi - lo, self.shape[1]),
                           {n: f[lo:hi] for n, f in self.fields.items()})

    def take_rows(self, ids: torch.Tensor) -> "QuantWeight":
        """Select output rows (M) — rows are whole block runs."""
        ids = ids.reshape(-1).to(self.device)
        return QuantWeight(self.fmt, (int(ids.numel()), self.shape[1]),
                           {n: f.index_select(0, ids)
                            for n, f in self.fields.items()})


def concat_m(weights: list) -> QuantWeight:
    """Concatenate quantized matrices along M (output features): a row
    concat of every field. Same format and K required."""
    first = weights[0]
    if any(w.fmt != first.fmt or w.shape[1] != first.shape[1]
           for w in weights):
        raise ValueError([(w.fmt, w.shape) for w in weights])
    return QuantWeight(
        first.fmt, (sum(w.shape[0] for w in weights), first.shape[1]),
        {n: torch.cat([w.fields[n] for w in weights], dim=0)
         for n in first.fields})


# --------------------------------------------------- torch dequantize ---


def _fp16(field: torch.Tensor, m: int) -> torch.Tensor:
    """(M, nb*2) uint8 fp16 bytes -> (M, nb) float32."""
    return field.view(m, -1, 2).contiguous().view(torch.float16).view(
        m, -1).float()


def kquant_parts(w: QuantWeight):
    """Q4_K or Q5_K blocks -> (d*sc, dmin*mn) per 32-block (M, K/256, 8)
    and the codes (M, K/256, 8, 32), all float32."""
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


def _dequant_kquant(w: QuantWeight) -> torch.Tensor:
    """x = (d*sc)*q - dmin*mn per 32-block."""
    scale, minv, q = kquant_parts(w)
    return (scale[..., None] * q - minv[..., None]).view(w.shape)


def _dequant_q6_k(w: QuantWeight) -> torch.Tensor:
    """x = (d*scale) * (q-32) per 16-element sub-block."""
    m, k = w.shape
    sb = k // QK_K
    f = w.fields
    ql = f["ql"].view(m, sb, 2, 2, 32).int()        # (half, slot, byte)
    qh = f["qh"].view(m, sb, 2, 1, 32).int()
    low4 = torch.cat([ql & 15, ql >> 4], dim=3).view(m, sb, QK_K)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32,
                          device=ql.device).view(1, 1, 1, 4, 1)
    hi2 = ((qh >> shifts) & 3).view(m, sb, QK_K)
    q = ((low4 | (hi2 << 4)) - 32).float().view(m, sb, 16, 16)
    scales = f["sc"].view(torch.int8).view(m, sb, 16).float()
    d = f["d"].view(m, sb, 2).view(torch.float16).float()
    return ((d * scales)[..., None] * q).view(m, k)


def _dequant_q8_0(w: QuantWeight) -> torch.Tensor:
    """x = d * q in f32 (exact: an fp16 d times an 8-bit q)."""
    m, k = w.shape
    d = _fp16(w.fields["d"], m)
    q = w.fields["qs"].view(torch.int8).view(m, k // QK, QK).float()
    return (d[..., None] * q).view(w.shape)


def legacy_offset(fmt: str) -> float:
    """The code offset of a `_0` format (x = d*(q - off)); 0 for `_1`."""
    return {"q4_0": 8.0, "q5_0": 16.0}.get(fmt, 0.0)


def legacy_parts(w: QuantWeight):
    """Q4_0/Q4_1/Q5_0/Q5_1 -> d (M, K/32), m (M, K/32) or None for the
    `_0` formats, and the raw codes (M, K/32, 32) before any offset, all
    float32. Byte j of a block's qs holds element j (low nibble) and
    j + 16 (high nibble); bit j of the little-endian u32 qh is element j's
    fifth bit."""
    m, k = w.shape
    nb = k // QK
    f = w.fields
    qs = f["qs"].view(m, nb, 16).int()
    q = torch.cat([qs & 15, qs >> 4], dim=-1)
    if "qh" in f:
        qh = f["qh"].view(m, nb, 4).contiguous().view(torch.int32)  # (m, nb, 1)
        bit = torch.arange(32, dtype=torch.int32, device=qh.device)
        q = q | (((qh >> bit) & 1) << 4)
    mn = _fp16(f["m"], m) if "m" in f else None
    return _fp16(f["d"], m), mn, q.float()


def _dequant_legacy(w: QuantWeight) -> torch.Tensor:
    """x = d*q + m (`_1`) or d*(q - off) (`_0`) in f32."""
    d, mn, q = legacy_parts(w)
    if mn is not None:
        return (d[..., None] * q + mn[..., None]).view(w.shape)
    return (d[..., None] * (q - legacy_offset(w.fmt))).view(w.shape)


def _crumbs(qs: torch.Tensor, m: int, sb: int) -> torch.Tensor:
    """(M, SB*64) Q2_K/Q3_K qs bytes -> (M, SB, 256) int32 2-bit codes in
    element order: crumb j of byte 32h + l is element 128h + 32j + l."""
    qv = qs.view(m, sb, 2, 1, 32).int()
    shifts = torch.arange(0, 8, 2, dtype=torch.int32,
                          device=qs.device).view(1, 1, 1, 4, 1)
    return ((qv >> shifts) & 3).view(m, sb, QK_K)


def q2_k_parts(w: QuantWeight):
    """Q2_K -> d*sc and dmin*mn per 16-element sub-block (M, K/256, 16)
    and the 2-bit codes (M, K/256, 16, 16), all float32."""
    m, k = w.shape
    sb = k // QK_K
    f = w.fields
    scm = f["sc"].view(m, sb, 16).int()
    d, dmin = _fp16(f["d"], m), _fp16(f["dmin"], m)
    scale16 = d[..., None] * (scm & 15).float()
    min16 = dmin[..., None] * (scm >> 4).float()
    return scale16, min16, _crumbs(f["qs"], m, sb).float().view(m, sb, 16, 16)


def _dequant_q2_k(w: QuantWeight) -> torch.Tensor:
    """x = (d*sc)*q - dmin*mn per 16-element sub-block."""
    scale16, min16, q = q2_k_parts(w)
    return (scale16[..., None] * q - min16[..., None]).view(w.shape)


def _q3_k_scales(scales: torch.Tensor, m: int, sb: int) -> torch.Tensor:
    """(M, SB*12) packed Q3_K scale bytes -> (M, SB, 16) int32 in
    [-32, 32): the low 4 bits of sub-block j in byte j (j < 8) or in the
    high nibble of byte j - 8, its top 2 bits at bit 2*(j // 4) of byte
    8 + j % 4."""
    s = scales.view(m, sb, 12).int()
    lo = torch.cat([s[..., :8] & 15, s[..., :8] >> 4], dim=-1)
    j = torch.arange(16, device=scales.device)
    hi = (s[..., 8 + j % 4] >> (2 * (j // 4)).int()) & 3
    return (lo | (hi << 4)) - 32


def _dequant_q3_k(w: QuantWeight) -> torch.Tensor:
    """x = (d*sc) * q per 16-element sub-block, q = (low2 | hbit<<2) - 4:
    bit b of hmask byte l is the third bit of element 32b + l."""
    m, k = w.shape
    sb = k // QK_K
    f = w.fields
    scale16 = _fp16(f["d"], m)[..., None] * _q3_k_scales(
        f["scales"], m, sb).float()
    hm = f["hmask"].view(m, sb, 1, 32).int()
    bit = torch.arange(8, dtype=torch.int32, device=hm.device).view(1, 1, 8, 1)
    hbit = ((hm >> bit) & 1).view(m, sb, QK_K)
    q = ((_crumbs(f["qs"], m, sb) | (hbit << 2)) - 4).float()
    return (scale16[..., None] * q.view(m, sb, 16, 16)).view(w.shape)


def _iq4_values(qs: torch.Tensor, m: int) -> torch.Tensor:
    """(M, nb*16) IQ4 code bytes -> (M, nb, 32) float32 codebook values:
    byte j of each 16 holds element j (low nibble) and j + 16 (high)."""
    q = qs.view(m, -1, 16).long()
    codes = torch.cat([q & 15, q >> 4], dim=-1)
    return _iq4_table(qs.device)[codes]


@functools.lru_cache(maxsize=None)
def _iq4_table(device: torch.device) -> torch.Tensor:
    """The IQ4 codebook as f32 on `device`, copied there once (a decode
    step that dequantizes embedding rows then copies nothing from the
    host, so a CUDA graph captures it)."""
    return torch.from_numpy(KVALUES.astype(np.float32)).to(device)


def _iq4_xs_scales(w: QuantWeight) -> torch.Tensor:
    """IQ4_XS -> d*ls per 32-element sub-block (M, K/256, 8) float32,
    ls = (scales_l nibble ib | ((scales_h >> 2*ib) & 3) << 4) - 32."""
    m, k = w.shape
    sb = k // QK_K
    f = w.fields
    sl = f["scales_l"].view(m, sb, 4).int()
    lo = torch.stack([sl & 15, sl >> 4], dim=-1).view(m, sb, 8)
    sh = f["scales_h"].view(m, sb, 2).int()
    sh = sh[..., 0] | (sh[..., 1] << 8)
    ib = torch.arange(8, dtype=torch.int32, device=sl.device)
    hi = (sh[..., None] >> (2 * ib)) & 3
    return _fp16(f["d"], m)[..., None] * ((lo | (hi << 4)) - 32).float()


def _dequant_iq4_nl(w: QuantWeight) -> torch.Tensor:
    """x = d * KVALUES[q] per 32-element block."""
    m = w.shape[0]
    d = _fp16(w.fields["d"], m)
    return (d[..., None] * _iq4_values(w.fields["qs"], m)).view(w.shape)


def _dequant_iq4_xs(w: QuantWeight) -> torch.Tensor:
    """x = (d*ls) * KVALUES[q] per 32-element sub-block."""
    m = w.shape[0]
    scale32 = _iq4_xs_scales(w).view(m, -1)
    return (scale32[..., None] * _iq4_values(w.fields["qs"], m)).view(w.shape)


_DEQUANT = {"q2_k": _dequant_q2_k, "q3_k": _dequant_q3_k,
            "q4_k": _dequant_kquant, "q5_k": _dequant_kquant,
            "q6_k": _dequant_q6_k, "q8_0": _dequant_q8_0,
            **{f: _dequant_legacy for f in LEGACY},
            "iq4_nl": _dequant_iq4_nl, "iq4_xs": _dequant_iq4_xs}
