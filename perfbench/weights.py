"""The cell's checkpoint, made from the seed: random GGUF block bytes on
the device, written with the port's GGUF writer into memory (a memfd, so
no disk block is written) and loaded by `LLM` through `load_llama`.

Each format's bytes come from one generator on the device, drawn in a
few large calls (chunks of 1 GiB per format). Codes and sub-block scales
stay as drawn, uniform over their bits; each format's fp16 super-block
scale fields are one constant, set so that the dequantized weights have
mean about 0 and std 0.5/sqrt(hidden_size), as the port's
`write_random_llama_gguf` draws them (`SCALE_DIV` gives the std of the
dequantized value per unit d):

- Q4_K: x = d*sc*q - dmin*m with sc, m uniform on 0..63 and q on 0..15;
  dmin = 7.5 d makes the mean 0, and E[(sc*q - 7.5*m)^2] = 66727.5.
- Q6_K: x = d*sc*(q - 32) with int8 sc and q on 0..63:
  E[sc^2]*E[(q-32)^2] = 5461.5 * 341.5.
- Q8_0: x = d*q with int8 q: E[q^2] = 5461.5.

The same seed gives the same bytes on the same device, so the reference
makes them again after the window instead of holding a copy.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .model import BLOCK, Model, nbytes, tensor_plan

SCALE_DIV = {"q4_k": 258.3167, "q6_k": 1365.6875, "q8_0": 73.9020}
_CHUNK = 1 << 30


def target_std(m: Model) -> float:
    return 0.5 / math.sqrt(m.dim)


def scale_fields(fmt: str, std: float) -> list:
    """(byte offset in the block, fp16 value) of each constant scale field."""
    d = std / SCALE_DIV[fmt]
    if fmt == "q4_k":
        return [(0, d), (2, 7.5 * d)]
    if fmt == "q6_k":
        return [(208, d)]
    return [(0, d)]


def make_bytes(m: Model, seed: int, device) -> dict:
    """{format: uint8 buffer on `device`}: the block bytes of every matrix
    of `tensor_plan(m)` in that format, in plan order (`views` names
    them)."""
    device = torch.device(device)
    plan = tensor_plan(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    buffers = {}
    for fmt in sorted({f for _, f, _ in plan}):
        total = sum(nbytes(fmt, *s) for _, f, s in plan if f == fmt)
        buf = torch.empty(total, dtype=torch.uint8, device=device)
        for lo in range(0, total, _CHUNK):
            buf[lo:lo + _CHUNK].random_(0, 256, generator=gen)
        blocks = buf.view(-1, BLOCK[fmt][1])
        for off, value in scale_fields(fmt, target_std(m)):
            field = torch.tensor([value], dtype=torch.float16).view(
                torch.uint8).to(device)
            blocks[:, off:off + 2] = field
        buffers[fmt] = buf
    return buffers


def views(m: Model, buffers: dict) -> dict:
    """{GGUF name: (format, (M, K), (M, bytes per row) view of its
    format's buffer)}."""
    out, lo = {}, dict.fromkeys(buffers, 0)
    for name, fmt, (rows, cols) in tensor_plan(m):
        n = nbytes(fmt, rows, cols)
        out[name] = (fmt, (rows, cols),
                     buffers[fmt][lo[fmt]:lo[fmt] + n].view(rows, -1))
        lo[fmt] += n
    return out


def metadata(m: Model) -> dict:
    """The GGUF keys llama.cpp's converter writes for a llama-architecture
    file of these sizes (no tokenizer: the engine then stops on no EOS)."""
    a = "llama"
    return {"general.architecture": a, f"{a}.vocab_size": m.vocab,
            f"{a}.embedding_length": m.dim, f"{a}.block_count": m.layers,
            f"{a}.attention.head_count": m.heads,
            f"{a}.attention.head_count_kv": m.kv_heads,
            f"{a}.feed_forward_length": m.ffn,
            f"{a}.attention.layer_norm_rms_epsilon": m.eps,
            f"{a}.rope.freq_base": m.theta,
            f"{a}.context_length": m.max_seq}


class Checkpoint:
    """The checkpoint as a GGUF file in memory: `path` names it until
    `close()`. Where the kernel has no memfd, the file goes to a fixed
    scratch path inside the checkout and `close()` deletes it."""

    def __init__(self, m: Model, buffers: dict, scratch_dir: str):
        from gguf_tpu_torch.gguf import GGMLType, write_gguf

        cpu = {fmt: buf.cpu() for fmt, buf in buffers.items()}  # one copy each
        host = {name: (GGMLType[fmt.upper()], shape, t.numpy())
                for name, (fmt, shape, t) in views(m, cpu).items()}
        ones = (GGMLType.F32, (m.dim,), np.ones(m.dim, np.float32))
        host["output_norm.weight"] = ones
        for i in range(m.layers):
            host[f"blk.{i}.attn_norm.weight"] = ones
            host[f"blk.{i}.ffn_norm.weight"] = ones
        self._fd = None
        if hasattr(os, "memfd_create"):
            self._fd = os.memfd_create("perfbench-checkpoint")
            self.path = f"/proc/self/fd/{self._fd}"
        else:
            os.makedirs(scratch_dir, exist_ok=True)
            self.path = os.path.join(scratch_dir, f"{m.name}.gguf")
        write_gguf(self.path, metadata(m), host)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        elif os.path.exists(self.path):
            os.remove(self.path)
