"""Quantized weights on the device: GGUF block bytes as stored, and their
dequantization in torch.

`QuantWeight` is the port's counterpart of `gguf_tpu.quant.layouts
.QuantTensor`. The TPU package re-lays every matrix into K-major
structure-of-arrays "planes" so each field is a 128-lane tile; a CUDA
kernel reads GGUF bytes directly, so the port keeps them as stored: rows
of the (M, K) matrix are runs of blocks, one row per output feature.

Q4_K's 144-byte and Q5_K's 176-byte superblocks are 16-byte aligned and
stay whole (field "blocks", (M, K/256*bytes) uint8). The other blocks are
not 4-byte aligned (Q6_K 210 bytes; Q8_0 34; Q4_0 18, Q4_1 20, Q5_0 22,
Q5_1 24), so they are split at load into per-field arrays, each a
(M, K/block*field_bytes) uint8 tensor whose rows keep the GGUF byte
order (`FIELDS`); `blocks()` reassembles the exact file bytes.

`dequantize()` runs in torch on the weight's own device, with the float
ops of `QuantTensor.dequantize()` in the same order, so bit-equal to it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

QK_K = 256
QK = 32
BLOCK_BYTES = {"q4_k": 144, "q5_k": 176, "q6_k": 210, "q8_0": 34,
               "q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24}
BLOCK_ELEMS = {**{f: QK_K for f in ("q4_k", "q5_k", "q6_k")},
               **{f: QK for f in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")}}
LEGACY = ("q4_0", "q4_1", "q5_0", "q5_1")
# the K a format's MMQ takes: Q8_0 any multiple of 32; the legacy formats
# multiples of 256, as the JAX package's `mmq_legacy` demands
K_MULTIPLE = {**BLOCK_ELEMS, **{f: QK_K for f in LEGACY}}
# (field, first byte, end byte) of one block of each split format
FIELDS = {
    "q6_k": (("ql", 0, 128), ("qh", 128, 192), ("sc", 192, 208),
             ("d", 208, 210)),
    "q8_0": (("d", 0, 2), ("qs", 2, 34)),
    "q4_0": (("d", 0, 2), ("qs", 2, 18)),
    "q4_1": (("d", 0, 2), ("m", 2, 4), ("qs", 4, 20)),
    "q5_0": (("d", 0, 2), ("qh", 2, 6), ("qs", 6, 22)),
    "q5_1": (("d", 0, 2), ("m", 2, 4), ("qh", 4, 8), ("qs", 8, 24)),
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
                f"{fmt} weights are not ported yet (ROADMAP.md, queue 2)")
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
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
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


_DEQUANT = {"q4_k": _dequant_kquant, "q5_k": _dequant_kquant,
            "q6_k": _dequant_q6_k, "q8_0": _dequant_q8_0,
            **{f: _dequant_legacy for f in LEGACY}}
