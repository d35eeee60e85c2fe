"""ctypes bridge to the port's K-quant quantizer core
(`gguf_tpu_torch/csrc/gguf_kquant.c`, built by `ops/build.py` with gcc at
first use): Q2_K, Q3_K, Q4_K, Q5_K and Q6_K, bit-identical to GGML's
reference quantizers. Inputs are float arrays whose size is a multiple of 256;
outputs are flat uint8 GGUF block bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np

QK_K = 256
BLOCK_BYTES = {"q2_k": 84, "q3_k": 110, "q4_k": 144, "q5_k": 176,
               "q6_k": 210}
_SIG = {f"gq_quantize_{fmt}": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64] for fmt in BLOCK_BYTES}


def get_lib() -> ctypes.CDLL:
    """Load (building if necessary) the quantizer library."""
    from ..ops import build

    return build.load("gguf_kquant", _SIG, restype=None)


def _quantize(x: np.ndarray, fmt: str) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x).reshape(-1), dtype=np.float32)
    n = x.size
    if n % QK_K:
        raise ValueError(f"{fmt} needs size % {QK_K} == 0, got {n}")
    out = np.empty(n // QK_K * BLOCK_BYTES[fmt], dtype=np.uint8)
    getattr(get_lib(), f"gq_quantize_{fmt}")(
        x.ctypes.data, out.ctypes.data, ctypes.c_int64(n))
    return out


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """float array (size % 256 == 0) -> flat GGUF Q2_K bytes (uint8)."""
    return _quantize(x, "q2_k")


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """float array (size % 256 == 0) -> flat GGUF Q3_K bytes (uint8)."""
    return _quantize(x, "q3_k")


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """float array (size % 256 == 0) -> flat GGUF Q4_K bytes (uint8)."""
    return _quantize(x, "q4_k")


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """float array (size % 256 == 0) -> flat GGUF Q5_K bytes (uint8)."""
    return _quantize(x, "q5_k")


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """float array (size % 256 == 0) -> flat GGUF Q6_K bytes (uint8)."""
    return _quantize(x, "q6_k")
