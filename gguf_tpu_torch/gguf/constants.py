"""GGUF file-format constants (v2/v3).

Spec: https://github.com/ggml-org/ggml/blob/master/docs/gguf.md
The port's own copy of `gguf_tpu/gguf/constants.py`, kept identical to it.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ4_NL = 20
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (elements per block, bytes per block)
GGML_BLOCK_INFO = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q2_K: (256, 84),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q8_K: (256, 292),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 36),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
    GGMLType.IQ4_NL: (32, 18),
    GGMLType.IQ4_XS: (256, 136),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.F64: (1, 8),
}

# ggml type -> our codec format name (for SoA transforms)
GGML_TO_FMT = {
    GGMLType.Q8_0: "q8_0",
    GGMLType.Q4_0: "q4_0",
    GGMLType.Q4_1: "q4_1",
    GGMLType.Q5_0: "q5_0",
    GGMLType.Q5_1: "q5_1",
    GGMLType.Q2_K: "q2_k",
    GGMLType.Q3_K: "q3_k",
    GGMLType.Q4_K: "q4_k",
    GGMLType.Q5_K: "q5_k",
    GGMLType.Q6_K: "q6_k",
    GGMLType.IQ4_NL: "iq4_nl",
    GGMLType.IQ4_XS: "iq4_xs",
}
FMT_TO_GGML = {v: k for k, v in GGML_TO_FMT.items()}


def tensor_nbytes(ggml_type, n_elements: int) -> int | None:
    """On-disk byte size, or None for types whose block size is unknown
    (the tensor table still parses — GGUF stores explicit offsets — and
    only LOADING such a tensor errors)."""
    info = GGML_BLOCK_INFO.get(ggml_type)
    if info is None:
        return None
    block, nbytes = info
    if n_elements % block:
        raise ValueError(f"{ggml_type.name}: {n_elements} not a multiple of block {block}")
    return n_elements // block * nbytes
