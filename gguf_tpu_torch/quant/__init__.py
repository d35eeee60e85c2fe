"""Quantized weight containers of the port (GGUF block bytes on the device)."""

from .layouts import QuantWeight, concat_m

__all__ = ["QuantWeight", "concat_m"]
