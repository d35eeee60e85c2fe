"""Serving engine of the port: continuous batching over an INT8 KV cache,
each decode chunk one CUDA graph replay on the card."""

from .engine import LLM, GenerationResult
from .sampler import SamplerConfig, logprobs, sample

__all__ = ["LLM", "GenerationResult", "SamplerConfig", "sample", "logprobs"]
