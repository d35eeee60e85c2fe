"""GGUF file I/O of the port: mmap reader, writer, format constants (the
port's own copy of `gguf_tpu.gguf`)."""

from .constants import GGMLType, GGUFValueType, GGML_TO_FMT, FMT_TO_GGML
from .reader import GGUFReader
from .writer import effective_quant_type, quantize_tensor, write_gguf

__all__ = [
    "GGUFReader", "write_gguf", "quantize_tensor", "effective_quant_type",
    "GGMLType", "GGUFValueType", "GGML_TO_FMT", "FMT_TO_GGML",
]
