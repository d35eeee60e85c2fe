"""GGUF v3 writer: typed metadata + tensors (float or pre-quantized).

The port's own copy of `gguf_tpu/gguf/writer.py`: `write_gguf`,
`effective_quant_type`, and `quantize_tensor` for the formats the port
reads (Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1,
IQ4_NL, IQ4_XS, and F32/F16); the others raise. The reference's activation-weighted (imatrix) quantizers
are not ported. Files are byte-identical to the reference writer's.
"""

from __future__ import annotations

import struct
from typing import Mapping

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC, GGUF_VERSION, GGMLType,
    GGUFValueType, tensor_nbytes,
)

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_vt(v) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot map {type(v)} to a GGUF value type")


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v, vt: GGUFValueType) -> bytes:
    if vt == GGUFValueType.STRING:
        return _pack_string(v)
    if vt == GGUFValueType.ARRAY:
        if isinstance(v, np.ndarray):
            dtype_map = {
                np.dtype(np.float32): GGUFValueType.FLOAT32,
                np.dtype(np.int32): GGUFValueType.INT32,
                np.dtype(np.uint32): GGUFValueType.UINT32,
                np.dtype(np.int64): GGUFValueType.INT64,
                np.dtype(np.uint64): GGUFValueType.UINT64,
                np.dtype(np.float64): GGUFValueType.FLOAT64,
                np.dtype(np.uint8): GGUFValueType.UINT8,
                np.dtype(np.int8): GGUFValueType.INT8,
                np.dtype(np.uint16): GGUFValueType.UINT16,
                np.dtype(np.int16): GGUFValueType.INT16,
                np.dtype(np.bool_): GGUFValueType.BOOL,
            }
            if v.dtype not in dtype_map:
                raise TypeError(
                    f"no GGUF value type for array dtype {v.dtype}")
            item_vt = dtype_map[v.dtype]
            body = v.astype(v.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IQ", item_vt, v.size) + body
        items = list(v)
        item_vt = _infer_vt(items[0]) if items else GGUFValueType.STRING
        out = struct.pack("<IQ", item_vt, len(items))
        for it in items:
            out += _pack_value(it, item_vt)
        return out
    return struct.pack(_SCALAR_PACK[vt], v)


def write_gguf(
    path: str,
    metadata: Mapping,
    tensors: Mapping[str, tuple],
    alignment: int = GGUF_DEFAULT_ALIGNMENT,
    metadata_types: Mapping | None = None,
) -> None:
    """Write a GGUF v3 file.

    tensors: name -> (ggml_type, shape, bytes_or_array) where shape is the
    numpy (row-major) shape and bytes are the GGUF block bytes (for quantized
    types) or a float/int numpy array (for F32/F16/I32).
    metadata_types: optional key -> GGUFValueType (e.g. a GGUFReader's
    .metadata_types) so rewritten files keep each key's EXACT value type —
    inference maps python float to FLOAT32 and positive ints to UINT32,
    which would silently retype FLOAT64/INT64 keys on a read-modify-write.
    """
    meta = dict(metadata)
    meta["general.alignment"] = alignment
    metadata_types = dict(metadata_types or {})
    metadata_types["general.alignment"] = GGUFValueType.UINT32

    header = bytearray()
    header += GGUF_MAGIC
    header += struct.pack("<I", GGUF_VERSION)
    header += struct.pack("<Q", len(tensors))
    # len(meta), not len(metadata)+1: the input may already carry
    # general.alignment (any rewritten file does) and the dict dedups
    header += struct.pack("<Q", len(meta))
    for key, val in meta.items():
        vt = metadata_types.get(key) or _infer_vt(val)
        header += _pack_string(key)
        header += struct.pack("<I", vt)
        header += _pack_value(val, vt)

    blobs = []
    offset = 0
    for name, (ggml_type, shape, data) in tensors.items():
        ggml_type = GGMLType(ggml_type)
        n_elems = int(np.prod(shape)) if shape else 1
        if isinstance(data, np.ndarray) and data.dtype != np.uint8:
            want = {GGMLType.F32: np.float32, GGMLType.F16: np.float16,
                    GGMLType.I32: np.int32}[ggml_type]
            raw = np.ascontiguousarray(data, dtype=want).tobytes()
        else:
            raw = np.asarray(data).view(np.uint8).tobytes()
        expect = tensor_nbytes(ggml_type, n_elems)
        if len(raw) != expect:
            raise ValueError(f"{name}: got {len(raw)} bytes, expected {expect}")

        header += _pack_string(name)
        dims = tuple(reversed(shape))  # GGUF order: ne[0] fastest-varying
        header += struct.pack("<I", len(dims))
        header += struct.pack(f"<{len(dims)}Q", *dims)
        header += struct.pack("<I", ggml_type)
        header += struct.pack("<Q", offset)

        blobs.append((offset, raw))
        offset += (len(raw) + alignment - 1) // alignment * alignment

    with open(path, "wb") as f:
        f.write(header)
        pad = (-len(header)) % alignment
        f.write(b"\0" * pad)
        data_start = len(header) + pad
        for off, raw in blobs:
            f.seek(data_start + off)
            f.write(raw)
        # pad the file tail to the aligned end for mmap friendliness
        f.truncate(data_start + offset)


_SUPERBLOCK_TYPES = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
                     GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_XS)


def effective_quant_type(ggml_type: GGMLType, row_len: int) -> GGMLType:
    """llama.cpp's fallback rule (llama_tensor_get_type): a tensor whose
    row length doesn't divide the format's block can't be stored at that
    type — superblock formats need row % 256 == 0, 32-block formats
    row % 32 == 0. Fall back to Q8_0, then F16."""
    if ggml_type in _SUPERBLOCK_TYPES and row_len % 256 != 0:
        ggml_type = GGMLType.Q8_0
    if ggml_type not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16) \
            and row_len % 32 != 0:
        ggml_type = GGMLType.F16
    return ggml_type


def quantize_tensor(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Quantize a float array to GGUF block bytes for the given type
    (F32 and F16 arrays pass through as that type).

    Rejects rows the format cannot represent (use effective_quant_type to
    pick the llama.cpp fallback first) — flat-quantizing across row
    boundaries would corrupt the block layout silently."""
    from ..quant import QUANTIZERS

    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32)
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float16)
    assert effective_quant_type(ggml_type, x.shape[-1]) == ggml_type, (
        f"{ggml_type.name} cannot store rows of {x.shape[-1]} elements "
        f"(use effective_quant_type for the llama.cpp fallback)")
    fn = QUANTIZERS.get(GGMLType(ggml_type).name.lower())
    if fn is None:
        raise NotImplementedError(
            f"quantizing to {GGMLType(ggml_type).name} is not supported")
    return np.asarray(fn(x))
