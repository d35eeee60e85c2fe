"""Serving engine of the port: continuous batching over an INT8 KV cache."""

from .engine import LLM, GenerationResult
from .sampler import SamplerConfig, sample

__all__ = ["LLM", "GenerationResult", "SamplerConfig", "sample"]
