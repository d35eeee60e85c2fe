"""Quantized weights on the device: GGUF block bytes as stored.

`QuantWeight` is the port's counterpart of `gguf_tpu.quant.layouts
.QuantTensor`. The TPU package re-lays every matrix into K-major
structure-of-arrays "planes" so each field is a 128-lane tile; a CUDA
kernel reads the interleaved GGUF blocks directly, so the port keeps them
as stored: one (M, K/256*bytes) uint8 row per output feature.

Q4_K's 144-byte and Q5_K's 176-byte blocks are 16-byte aligned and stay
whole. Q6_K's 210-byte
block is not 4-byte aligned, so it is split at load into per-field arrays
(ql, qh, scales, d), each a (M, K/256*field_bytes) uint8 tensor whose rows
keep the GGUF byte order; `blocks()` reassembles the exact file bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

QK_K = 256
BLOCK_BYTES = {"q4_k": 144, "q5_k": 176, "q6_k": 210}
# (field, first byte, end byte) of one Q6_K superblock (gguf_tpu/quant/q6_k.py)
Q6K_FIELDS = (("ql", 0, 128), ("qh", 128, 192), ("sc", 192, 208),
              ("d", 208, 210))


def _codec(fmt: str):
    from gguf_tpu.quant import (dequantize_q4_k, dequantize_q5_k,
                                dequantize_q6_k)

    codecs = {"q4_k": dequantize_q4_k, "q5_k": dequantize_q5_k,
              "q6_k": dequantize_q6_k}
    if fmt not in codecs:
        raise NotImplementedError(
            f"{fmt} weights are not ported yet (ROADMAP.md, queue 2)")
    return codecs[fmt]


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
        _codec(fmt)
        m, k = shape
        if k % QK_K:
            raise ValueError(f"K must be a multiple of {QK_K}, got {k}")
        sb = k // QK_K
        raw = np.asarray(blocks, dtype=np.uint8).reshape(m, sb * BLOCK_BYTES[fmt])
        t = torch.from_numpy(raw.copy())
        if fmt == "q6_k":
            per = t.view(m, sb, BLOCK_BYTES[fmt])
            fields = {name: per[:, :, lo:hi].reshape(m, -1).contiguous()
                      .to(device) for name, lo, hi in Q6K_FIELDS}
        else:
            fields = {"blocks": t.to(device)}
        return cls(fmt, (m, k), fields)

    @property
    def device(self) -> torch.device:
        return next(iter(self.fields.values())).device

    def blocks(self) -> torch.Tensor:
        """(M, K/256*bytes) uint8: the tensor's GGUF bytes, on its device."""
        if self.fmt == "q6_k":
            m, sb = self.shape[0], self.shape[1] // QK_K
            return torch.cat([self.fields[n].view(m, sb, -1)
                              for n, _, _ in Q6K_FIELDS], dim=2).view(m, -1)
        return self.fields["blocks"]

    def dequantize(self) -> torch.Tensor:
        """(M, K) float32 on the weight's device, computed by the
        `gguf_tpu.quant` codec on the CPU (bit-exact GGUF semantics)."""
        raw = self.blocks().cpu().numpy()
        out = np.asarray(_codec(self.fmt)(raw, self.shape), np.float32)
        return torch.from_numpy(np.ascontiguousarray(out)).to(self.device)

    def take_rows(self, ids: torch.Tensor) -> "QuantWeight":
        """Select output rows (M) — rows are whole superblock runs."""
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
