"""Llama-family decoder of the port: config, GGUF loader, forward."""

from .config import LlamaConfig
from .convert import params_from_jax
from .llama import (MMOpts, forward, fuse_llama_params, init_kv_cache,
                    linear)
from .loader import GGMLType, load_llama, write_random_llama_gguf

__all__ = [
    "GGMLType", "LlamaConfig", "MMOpts", "forward", "fuse_llama_params",
    "init_kv_cache", "linear", "load_llama", "params_from_jax",
    "write_random_llama_gguf",
]
