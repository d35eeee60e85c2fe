"""A configuration file as the harness runs it: the sizes, the module of
its architecture, and the quantization recipe that sets each tensor's
format.

Every count the harness makes (bytes, FLOPs, the reference's weights)
starts from `Model` and its architecture's `tensor_plan`, never from the
program's objects. The architecture is `perfbench/archs/<name>.py`, named
by the configuration file's `architecture` key and found by that name
(`arch`), as metric readers and references are found; `perfbench.archs`
says what such a module provides.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))

# GGUF block formats the recipes use: (elements, bytes) per block
BLOCK = {"q2_k": (256, 84), "q3_k": (256, 110), "q4_k": (256, 144),
         "q5_k": (256, 176), "q6_k": (256, 210), "q8_0": (32, 34)}
F32 = "f32"


class Tensor(NamedTuple):
    """One tensor of the checkpoint: its GGUF name, its format (a `BLOCK`
    format, or `F32`), its shape (any tuple whose last entry is the row
    length K: (M, K) for a matrix, (E, M, K) for a stack of experts), and
    for an F32 tensor how it is made: "ones" (a norm), or a float std of
    a normal draw from the seed (a router)."""
    name: str
    fmt: str
    shape: tuple
    init: object = None


@dataclass(frozen=True)
class Model:
    name: str
    architecture: str
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    eps: float
    theta: float
    tied: bool
    recipe: str
    max_seq: int
    max_batch: int
    # every key of the configuration file, for what an architecture reads
    # beyond the fields above (such as `num_local_experts`)
    config: dict = field(default_factory=dict, compare=False, hash=False,
                         repr=False)

    @classmethod
    def from_file(cls, name: str, path: str) -> "Model":
        with open(path) as f:
            return cls.from_config(name, json.load(f))

    @classmethod
    def from_config(cls, name: str, c: dict) -> "Model":
        dim, heads = c["hidden_size"], c["num_attention_heads"]
        return cls(name=name, architecture=c["architecture"],
                   vocab=c["vocab_size"], dim=dim,
                   layers=c["num_hidden_layers"], heads=heads,
                   kv_heads=c["num_key_value_heads"],
                   head_dim=int(c.get("head_dim") or dim // heads),
                   ffn=c["intermediate_size"], eps=float(c["rms_norm_eps"]),
                   theta=float(c["rope_theta"]),
                   tied=bool(c["tie_word_embeddings"]), recipe=c["recipe"],
                   max_seq=int(c["max_seq"]), max_batch=int(c["max_batch"]),
                   config=c)


def arch(m: Model):
    """The module of the model's architecture, `perfbench/archs/<name>.py`
    (or one registered under `perfbench.archs.<name>` in `sys.modules`)."""
    return importlib.import_module(f"perfbench.archs.{m.architecture}")


def tensor_plan(m: Model) -> list:
    """Every tensor of the model's file in file order (`Tensor`s)."""
    return arch(m).tensor_plan(m)


def nbytes(fmt: str, shape: tuple) -> int:
    """Bytes of a tensor of `shape` stored in `fmt`."""
    rows = 1
    for n in shape[:-1]:
        rows *= n
    if fmt == F32:
        return 4 * rows * shape[-1]
    elems, size = BLOCK[fmt]
    return rows * (shape[-1] // elems) * size


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's `use_more_bits` (src/llama-quant.cpp)."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


def _layer(name: str) -> int:
    found = re.match(r"blk\.(\d+)\.", name)
    if found is None:
        raise ValueError(f"no layer in tensor name {name!r}")
    return int(found.group(1))


def tensor_format(recipe: str, name: str, n_layers: int, n_expert: int = 0,
                  has_output: bool = True, gqa: int = 1) -> str:
    """The format of the matrix `name` (its GGUF name) under a recipe,
    following llama.cpp's `llama_tensor_get_type` (src/llama-quant.cpp)
    for a llama-architecture file of `n_layers` layers, `n_expert` routed
    experts (0 for a dense model) and `gqa` query heads per KV head. The
    layer of a tensor is parsed from its `blk.N.` prefix, as llama.cpp's
    `layer_info` does for expert models; in a dense file that is the order
    it counts them in.

    - `q8_0` (LLAMA_FTYPE_MOSTLY_Q8_0): every matrix Q8_0.
    - `q4_k_m` (LLAMA_FTYPE_MOSTLY_Q4_K_M): Q4_K, except output Q6_K (and
      token_embd where the file has no output: the tied head takes the
      output's rule); attn_v Q6_K on the `use_more_bits` layers; any
      ffn_down (ffn_down_exps too) Q6_K where its layer `use_more_bits`.
    - `q2_k` (LLAMA_FTYPE_MOSTLY_Q2_K): Q2_K, except output Q6_K (the
      tied token_embd likewise); attn_v Q4_K where gqa >= 4, else Q3_K;
      attn_output and any ffn_down Q3_K.
    - With 8 experts, under either K recipe: attn_k and attn_v Q8_0,
      attn_output Q5_K.
    - Every recipe: a router, ffn_gate_inp, is never quantized (llama.cpp's
      quantize loop leaves it as converted, F32).
    """
    if name.endswith("ffn_gate_inp.weight"):
        return F32
    if recipe == "q8_0":
        return "q8_0"
    if recipe not in ("q4_k_m", "q2_k"):
        raise ValueError(f"unknown recipe {recipe!r}")
    q2 = recipe == "q2_k"
    base = "q2_k" if q2 else "q4_k"
    if name == "output.weight" or (name == "token_embd.weight"
                                   and not has_output):
        return "q6_k"
    if name == "token_embd.weight":
        return base
    eight = n_expert == 8
    if ".attn_k." in name:
        return "q8_0" if eight else base
    if ".attn_v." in name:
        if eight:
            return "q8_0"
        if q2:
            return "q4_k" if gqa >= 4 else "q3_k"
        return "q6_k" if use_more_bits(_layer(name), n_layers) else base
    if ".attn_output." in name:
        return "q5_k" if eight else "q3_k" if q2 else base
    if ".ffn_down" in name:
        if q2:
            return "q3_k"
        return "q6_k" if use_more_bits(_layer(name), n_layers) else base
    return base
