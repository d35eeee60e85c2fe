"""Q8_0 quantizer — 32-element blocks, 34 bytes: [d: fp16][qs: 32 x int8].

The port's own copy of `gguf_tpu/quant/q8_0.py:quantize_q8_0`. Element
value x = d * q, with d = absmax/127 computed in fp16 arithmetic (numpy
float16 ops compute in f32 and round to f16). All-zero blocks store
d = 1.0, as the reference does, so quantized bytes are identical. The
port dequantizes in torch (`QuantWeight.dequantize`: f32 d * q, exact).
"""

from __future__ import annotations

import numpy as np

BLOCK = 32
BLOCK_BYTES = 34


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """float array (size % 32 == 0; rounded to float16 first) -> flat GGUF
    Q8_0 bytes (uint8)."""
    x = np.asarray(x, dtype=np.float16).reshape(-1)
    if x.size % BLOCK:
        raise ValueError(f"Q8_0 needs size % {BLOCK} == 0, got {x.size}")
    g = x.reshape(-1, BLOCK)
    amax = np.max(np.abs(g), axis=1)  # fp16

    d = np.ones(g.shape[0], dtype=np.float16)
    nz = amax != 0
    d[nz] = amax[nz] / np.float16(127.0)  # fp16 division

    q = np.rint((g / d[:, None]).astype(np.float16)).astype(np.float32)
    q = np.clip(q, -127, 127).astype(np.int8)

    out = np.empty((g.shape[0], BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)
