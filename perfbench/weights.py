"""The cell's checkpoint, made from the seed: random GGUF block bytes on
the device, written as a GGUF file into memory (a memfd, so no disk
block is written) and loaded by `LLM` through `load_llama`.

Each block format's bytes come from one generator on the device, drawn in
a few large calls (chunks of 1 GiB per format, the formats in sorted
order). Codes and sub-block scales stay as drawn, uniform over their
bits; each format's fp16 super-block scale fields are one constant, set so
that the dequantized weights have mean about 0 and std
0.5/sqrt(hidden_size), as the port's `write_random_llama_gguf` draws them
(`SCALE_DIV` gives the std of the dequantized value per unit d):

- Q4_K: x = d*sc*q - dmin*m with sc, m uniform on 0..63 and q on 0..15;
  dmin = 7.5 d makes the mean 0, and E[(sc*q - 7.5*m)^2] = 66727.5.
- Q5_K: the same with q on 0..31 (a fifth bit from qh): dmin = 15.5 d
  makes the mean 0, and E[(sc*q - 15.5*m)^2] = E[sc^2] E[q^2]
  - 31 E[sc] E[q] E[m] + 15.5^2 E[m^2] = 1333.5 * 325.5
  - 31 * 31.5 * 15.5 * 31.5 + 240.25 * 1333.5 = 277651.5.
- Q2_K: x = d*sc*q - dmin*m with sc, m uniform on 0..15 and q on 0..3:
  dmin = 1.5 d, E[(sc*q - 1.5*m)^2] = 77.5 * 3.5 - 3 * 7.5 * 1.5 * 7.5
  + 2.25 * 77.5 = 192.5.
- Q3_K: x = d*(sc - 32)*q with sc on 0..63 and q on -4..3 (two low bits,
  less 4 where the hmask bit is clear): E[(sc-32)^2] E[q^2] = 341.5 * 5.5
  (mean 0.25 d, under a hundredth of the std).
- Q6_K: x = d*sc*(q - 32) with int8 sc and q on 0..63:
  E[sc^2]*E[(q-32)^2] = 5461.5 * 341.5.
- Q8_0: x = d*q with int8 q: E[q^2] = 5461.5.

F32 tensors follow the block formats: norms are ones, and a tensor with a
stated std (a router) is a normal draw from the same generator, in plan
order. The same seed gives the same bytes on the same device, so the
reference makes them again after the window instead of holding a copy.
"""

from __future__ import annotations

import math
import os
import struct

import torch

from .model import BLOCK, F32, Model, arch, nbytes, tensor_plan

SCALE_DIV = {"q2_k": 13.8744, "q3_k": 43.3388, "q4_k": 258.3167,
             "q5_k": 526.9265, "q6_k": 1365.6875, "q8_0": 73.9020}
_CHUNK = 1 << 30
# GGUF v3, as llama.cpp's gguf.h defines it
GGUF_ALIGNMENT = 32
GGML_TYPE = {"f32": 0, "q8_0": 8, "q2_k": 10, "q3_k": 11, "q4_k": 12,
             "q5_k": 13, "q6_k": 14}


def target_std(m: Model) -> float:
    return 0.5 / math.sqrt(m.dim)


def scale_fields(fmt: str, std: float) -> list:
    """(byte offset in the block, fp16 value) of each constant scale field."""
    d = std / SCALE_DIV[fmt]
    return {"q2_k": [(80, d), (82, 1.5 * d)], "q3_k": [(108, d)],
            "q4_k": [(0, d), (2, 7.5 * d)], "q5_k": [(0, d), (2, 15.5 * d)],
            "q6_k": [(208, d)], "q8_0": [(0, d)]}[fmt]


def seeded_blocks(fmt: str, total: int, std: float, gen: torch.Generator,
                  device) -> torch.Tensor:
    """`total` bytes of `fmt` blocks drawn from `gen`, the scale fields set
    for `std`."""
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    for lo in range(0, total, _CHUNK):
        buf[lo:lo + _CHUNK].random_(0, 256, generator=gen)
    blocks = buf.view(-1, BLOCK[fmt][1])
    for off, value in scale_fields(fmt, std):
        field = torch.tensor([value], dtype=torch.float16).view(
            torch.uint8).to(device)
        blocks[:, off:off + 2] = field
    return buf


def make_bytes(m: Model, seed: int, device) -> dict:
    """{format: buffer on `device`}: the bytes of every tensor of
    `tensor_plan(m)` in that format, in plan order (`views` names them);
    uint8 for a block format, float32 for `F32`."""
    device = torch.device(device)
    plan = tensor_plan(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    buffers = {}
    for fmt in sorted({t.fmt for t in plan} - {F32}):
        total = sum(nbytes(fmt, t.shape) for t in plan if t.fmt == fmt)
        buffers[fmt] = seeded_blocks(fmt, total, target_std(m), gen, device)
    floats = [t for t in plan if t.fmt == F32]
    if floats:
        buf = torch.empty(sum(math.prod(t.shape) for t in floats),
                          dtype=torch.float32, device=device)
        lo = 0
        for t in floats:
            part = buf[lo:lo + math.prod(t.shape)]
            if t.init == "ones":
                part.fill_(1.0)
            else:
                part.normal_(0.0, float(t.init), generator=gen)
            lo += part.numel()
        buffers[F32] = buf
    return buffers


def views(m: Model, buffers: dict) -> dict:
    """{GGUF name: (format, shape, view of its format's buffer)}: a block
    tensor's view is uint8 of shape (*shape[:-1], bytes per row), an F32
    one float32 of its shape."""
    out, lo = {}, dict.fromkeys(buffers, 0)
    for t in tensor_plan(m):
        n = math.prod(t.shape) if t.fmt == F32 else nbytes(t.fmt, t.shape)
        part = buffers[t.fmt][lo[t.fmt]:lo[t.fmt] + n]
        out[t.name] = (t.fmt, t.shape, part.view(*t.shape) if t.fmt == F32
                       else part.view(*t.shape[:-1], -1))
        lo[t.fmt] += n
    return out


def metadata(m: Model) -> dict:
    """The file's GGUF keys (the architecture's `metadata`)."""
    return arch(m).metadata(m)


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _value(v) -> bytes:
    """GGUF value type and value, typed as the port's writer types a
    Python value: int as UINT32, float as FLOAT32, str as STRING."""
    if isinstance(v, int) and not isinstance(v, bool) and 0 <= v < 2**32:
        return struct.pack("<II", 4, v)
    if isinstance(v, float):
        return struct.pack("<If", 6, v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + _string(v)
    raise TypeError(f"no GGUF value type here for {v!r}")


def gguf_layout(meta: dict, plan: list) -> tuple:
    """(header bytes padded to the alignment, each tensor's offset from
    the end of the header, the data's padded length) of a GGUF v3 file of
    `meta` and `plan`'s tensors in plan order."""
    meta = {**meta, "general.alignment": GGUF_ALIGNMENT}
    head = bytearray(b"GGUF" + struct.pack("<IQQ", 3, len(plan), len(meta)))
    for key, value in meta.items():
        head += _string(key) + _value(value)
    offsets, end = [], 0
    for t in plan:
        dims = tuple(reversed(t.shape))       # GGUF: ne[0] varies fastest
        head += (_string(t.name) + struct.pack(f"<I{len(dims)}Q", len(dims),
                                               *dims)
                 + struct.pack("<IQ", GGML_TYPE[t.fmt], end))
        offsets.append(end)
        end += -(-nbytes(t.fmt, t.shape) // GGUF_ALIGNMENT) * GGUF_ALIGNMENT
    head += b"\0" * (-len(head) % GGUF_ALIGNMENT)
    return bytes(head), offsets, end


class Checkpoint:
    """The checkpoint as a GGUF file in memory: `path` names it until
    `close()`. Where the kernel has no memfd, the file goes to a fixed
    scratch path inside the checkout and `close()` deletes it.

    Each tensor is copied to the host and written on its own, so the host
    holds one tensor at a time, not the checkpoint."""

    def __init__(self, m: Model, buffers: dict, scratch_dir: str):
        plan = tensor_plan(m)
        head, offsets, end = gguf_layout(metadata(m), plan)
        w = views(m, buffers)
        self._fd = None
        if hasattr(os, "memfd_create"):
            self._fd = os.memfd_create("perfbench-checkpoint")
            self.path = f"/proc/self/fd/{self._fd}"
        else:
            os.makedirs(scratch_dir, exist_ok=True)
            self.path = os.path.join(scratch_dir, f"{m.name}.gguf")
        try:
            with open(self.path, "wb") as f:
                f.write(head)
                for t, off in zip(plan, offsets):
                    f.seek(len(head) + off)
                    f.write(w[t.name][2].cpu().numpy())
                f.truncate(len(head) + end)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        elif os.path.exists(self.path):
            os.remove(self.path)
