"""Convert the JAX package's Llama params into the port's.

The caller hands over the reference params with every `QuantTensor` given
as `(fmt, gguf_bytes, (M, K))` — the bytes from
`gguf_tpu.quant.layouts.from_soa(t)`, which also undoes the TPU's Q8_0
plane order — and every float array as numpy, so this module needs no
jax. The reference loader zero-pads M and K for TPU tiles (vocab rows,
FFN width); the padding is stripped back to the config's true shapes,
whole blocks at a time (256 elements for the K-quants and IQ4_XS, 32 for
Q8_0, the legacy formats and IQ4_NL).
"""

from __future__ import annotations

import numpy as np
import torch

from ..quant.layouts import BLOCK_BYTES, BLOCK_ELEMS, QuantWeight
from .config import LlamaConfig


def _true_shapes(cfg: LlamaConfig) -> dict:
    q_d = cfg.n_heads * cfg.head_dim
    kv_d = cfg.n_kv_heads * cfg.head_dim
    return {"token_embd": (cfg.vocab_size, cfg.dim),
            "output": (cfg.vocab_size, cfg.dim),
            "wq": (q_d, cfg.dim), "wk": (kv_d, cfg.dim), "wv": (kv_d, cfg.dim),
            "wo": (cfg.dim, q_d),
            "gate": (cfg.ffn_dim, cfg.dim), "up": (cfg.ffn_dim, cfg.dim),
            "down": (cfg.dim, cfg.ffn_dim)}


def _convert(name: str, value, shapes: dict, device):
    if not isinstance(value, tuple):
        return torch.from_numpy(np.array(value)).to(device)
    fmt, raw, (m_pad, k_pad) = value
    m, k = shapes[name]
    per = BLOCK_ELEMS[fmt]
    blocks = np.asarray(raw, np.uint8).reshape(m_pad, k_pad // per,
                                               BLOCK_BYTES[fmt])
    return QuantWeight.from_blocks(fmt, blocks[:m, :k // per], (m, k), device)


def params_from_jax(np_params: dict, cfg: LlamaConfig, device) -> dict:
    """Reference params (quantized weights as (fmt, bytes, (M, K)), floats
    as numpy) -> the port's params on `device`, unpadded to `cfg`."""
    shapes = _true_shapes(cfg)
    out = {name: _convert(name, val, shapes, device)
           for name, val in np_params.items() if name != "layers"}
    out["layers"] = [{name: _convert(name, val, shapes, device)
                      for name, val in layer.items()}
                     for layer in np_params["layers"]]
    return out
