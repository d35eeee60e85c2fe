"""GGUF checkpoint -> the port's model params, and the random-checkpoint
writer (llama architecture).

Counterpart of `gguf_tpu/models/loader.py`: `load_llama` (llama branch)
and `write_random_llama_gguf` (arch "llama"), on the port's own GGUF
reader and writer. The reference's `_pad_vocab_weights` and
`pad_ffn_for_tp` pad M and K for TPU tiles; the port's kernels take any M
and any K that is a multiple of the format's block (`QuantWeight`), so it
loads weights unpadded.

Params layout (same keys as the reference): {"token_embd", "output",
"output_norm", "layers": [{"attn_norm", "ffn_norm", "wq", "wk", "wv",
"wo", "gate", "up", "down"}, ...]}; quantized weights are `QuantWeight`s,
float tensors stay in their file dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf import (GGML_TO_FMT, GGMLType, GGUFReader, quantize_tensor,
                    write_gguf)
from ..quant.layouts import QuantWeight
from .config import LlamaConfig

_FLOAT_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


def _load_weight(reader: GGUFReader, name: str, device):
    ti = reader.tensors[name]
    if ti.ggml_type in _FLOAT_TYPES:
        return torch.from_numpy(np.array(reader.load_array(name))).to(device)
    fmt = GGML_TO_FMT.get(ti.ggml_type)
    if fmt is None:
        raise ValueError(f"{name}: unsupported tensor type {ti.ggml_type}")
    *lead, k = ti.shape
    m = int(np.prod(lead)) if lead else 1
    return QuantWeight.from_blocks(fmt, reader.tensor_bytes(name), (m, k),
                                   device)


def _load_f32(reader: GGUFReader, name: str, device) -> torch.Tensor:
    arr = np.asarray(reader.load_array(name), np.float32)
    return torch.from_numpy(arr.copy()).to(device)


def load_llama(path: str, device):
    """Load a llama-architecture GGUF onto `device`: (cfg, params)."""
    device = torch.device(device)
    with GGUFReader(path) as reader:
        arch = reader.metadata.get("general.architecture", "llama")
        if arch != "llama":
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (ROADMAP.md, "
                "queue 1: remaining model families)")
        cfg = LlamaConfig.from_gguf_metadata(reader.metadata)
        if "rope_freqs.weight" in reader.tensors:
            cfg = dataclasses.replace(cfg, rope_freq_factors=tuple(
                float(x) for x in reader.load_array("rope_freqs.weight")))
        params = {
            "token_embd": _load_weight(reader, "token_embd.weight", device),
            "output_norm": _load_f32(reader, "output_norm.weight", device),
            "layers": [],
        }
        params["output"] = (_load_weight(reader, "output.weight", device)
                            if "output.weight" in reader.tensors
                            else params["token_embd"])
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            layer = {nk: _load_f32(reader, p + tk, device)
                     for nk, tk in (("attn_norm", "attn_norm.weight"),
                                    ("ffn_norm", "ffn_norm.weight"))}
            for nk, tk in (("wq", "attn_q"), ("wk", "attn_k"),
                           ("wv", "attn_v"), ("wo", "attn_output"),
                           ("gate", "ffn_gate"), ("up", "ffn_up"),
                           ("down", "ffn_down")):
                layer[nk] = _load_weight(reader, p + tk + ".weight", device)
            params["layers"].append(layer)
    return cfg, params


def write_random_llama_gguf(path: str, cfg: LlamaConfig,
                            fmt: GGMLType = GGMLType.Q4_K, seed: int = 0,
                            extra_metadata: dict | None = None) -> None:
    """Write a random llama-architecture GGUF (tests, smoke runs); `fmt`
    is a `GGMLType` (re-exported by `gguf_tpu_torch.models`).

    Byte-identical to `gguf_tpu.models.write_random_llama_gguf(path, cfg,
    fmt, seed, extra_metadata)` with arch "llama": the same generator
    draws in the same order. Projections and the embedding are quantized
    to `fmt`; the output head is Q6_K for Q4_K, Q5_K and Q6_K `fmt`
    (llama.cpp's Q4_K_M recipe) and `fmt` otherwise (Q2_K, Q3_K, Q8_0,
    Q4_0, IQ4_XS, ...); norms are F32 ones."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    q_d = cfg.n_heads * cfg.head_dim
    kv_d = cfg.n_kv_heads * cfg.head_dim
    scale = 0.5 / np.sqrt(d)

    def w(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def quant(shape, t=fmt):
        return (t, shape, quantize_tensor(w(shape), t))

    def ones(n):
        return (GGMLType.F32, (n,), np.ones(n, np.float32))

    head_fmt = (GGMLType.Q6_K if fmt in (GGMLType.Q4_K, GGMLType.Q5_K,
                                         GGMLType.Q6_K) else fmt)
    tensors = {
        "token_embd.weight": quant((v, d)),
        "output.weight": quant((v, d), head_fmt),
        "output_norm.weight": ones(d),
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        tensors[p + "attn_norm.weight"] = ones(d)
        tensors[p + "ffn_norm.weight"] = ones(d)
        for name, shape in (("attn_q.weight", (q_d, d)),
                            ("attn_k.weight", (kv_d, d)),
                            ("attn_v.weight", (kv_d, d)),
                            ("attn_output.weight", (d, q_d)),
                            ("ffn_gate.weight", (f, d)),
                            ("ffn_up.weight", (f, d)),
                            ("ffn_down.weight", (d, f))):
            tensors[p + name] = quant(shape)
    if cfg.rope_freq_factors is not None:
        rd = cfg.rope_dim or cfg.head_dim
        tensors["rope_freqs.weight"] = (
            GGMLType.F32, (rd // 2,),
            np.asarray(cfg.rope_freq_factors, np.float32))
    md = cfg.to_gguf_metadata("llama")
    md.update(extra_metadata or {})
    write_gguf(path, md, tensors)
