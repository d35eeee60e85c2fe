"""A configuration file as the harness runs it: the sizes, the tensors of
its GGUF file and the format of each (the quantization recipe).

Every count the harness makes (bytes, FLOPs, the reference's weights)
starts from `Model` and `tensor_plan`, never from the program's objects.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))

# GGUF block formats the recipes use: (elements, bytes) per block
BLOCK = {"q4_k": (256, 144), "q6_k": (256, 210), "q8_0": (32, 34)}

PROJECTIONS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
               "ffn_up", "ffn_down")


@dataclass(frozen=True)
class Model:
    name: str
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    eps: float
    theta: float
    tied: bool
    recipe: str
    max_seq: int
    max_batch: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def from_file(cls, name: str, path: str) -> "Model":
        with open(path) as f:
            c = json.load(f)
        return cls(name=name, vocab=c["vocab_size"], dim=c["hidden_size"],
                   layers=c["num_hidden_layers"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   ffn=c["intermediate_size"], eps=float(c["rms_norm_eps"]),
                   theta=float(c["rope_theta"]),
                   tied=bool(c["tie_word_embeddings"]), recipe=c["recipe"],
                   max_seq=int(c["max_seq"]), max_batch=int(c["max_batch"]))


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's `use_more_bits` (src/llama-quant.cpp)."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


def tensor_format(recipe: str, name: str, i_layer: int,
                  n_layers: int) -> str:
    """The format of one matrix under a recipe: `q8_0` is every matrix in
    Q8_0; `q4_k_m` is llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M
    (`llama_tensor_get_type`): attn_v and ffn_down Q6_K on the
    `use_more_bits` layers and Q4_K elsewhere, output Q6_K, every other
    matrix (token_embd included) Q4_K."""
    if recipe == "q8_0":
        return "q8_0"
    if recipe != "q4_k_m":
        raise ValueError(f"unknown recipe {recipe!r}")
    if name == "output":
        return "q6_k"
    if name in ("attn_v", "ffn_down") and use_more_bits(i_layer, n_layers):
        return "q6_k"
    return "q4_k"


def projection_shape(m: Model, proj: str) -> tuple:
    """(rows M, columns K) of a layer's projection."""
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    return {"attn_q": (q, m.dim), "attn_k": (kv, m.dim),
            "attn_v": (kv, m.dim), "attn_output": (m.dim, q),
            "ffn_gate": (m.ffn, m.dim), "ffn_up": (m.ffn, m.dim),
            "ffn_down": (m.dim, m.ffn)}[proj]


def tensor_plan(m: Model) -> list:
    """Every quantized matrix of the file in file order: (GGUF name, format,
    (M, K)). A tied model has no output.weight: its head is token_embd."""
    plan = [("token_embd.weight", tensor_format(m.recipe, "token_embd", -1,
                                                m.layers), (m.vocab, m.dim))]
    if not m.tied:
        plan.append(("output.weight", tensor_format(m.recipe, "output", -1,
                                                    m.layers),
                     (m.vocab, m.dim)))
    for i in range(m.layers):
        for proj in PROJECTIONS:
            plan.append((f"blk.{i}.{proj}.weight",
                         tensor_format(m.recipe, proj, i, m.layers),
                         projection_shape(m, proj)))
    return plan


def nbytes(fmt: str, rows: int, cols: int) -> int:
    elems, size = BLOCK[fmt]
    return rows * (cols // elems) * size
