"""The llama GGUF schema with a dense SwiGLU FFN (llama.cpp's
LLM_ARCH_LLAMA without experts): the tensors of the file, its keys, and
the work a token and a decode step need.

File order: token_embd, output (absent where the head is tied), each
layer's seven projections, then the norms (output_norm, each layer's
attn_norm and ffn_norm), all ones.
"""

from __future__ import annotations

import dataclasses

from ..model import F32, Model, Tensor, nbytes, tensor_format
from ..roofline import KV_SCALE_BYTES

PROJECTIONS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
               "ffn_up", "ffn_down")


def projection_shape(m: Model, proj: str) -> tuple:
    """(rows M, columns K) of a layer's projection."""
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    return {"attn_q": (q, m.dim), "attn_k": (kv, m.dim),
            "attn_v": (kv, m.dim), "attn_output": (m.dim, q),
            "ffn_gate": (m.ffn, m.dim), "ffn_up": (m.ffn, m.dim),
            "ffn_down": (m.dim, m.ffn)}[proj]


def matrix(m: Model, name: str, shape: tuple, n_expert: int = 0) -> Tensor:
    """A quantized tensor in the format the model's recipe gives it."""
    return Tensor(name, tensor_format(m.recipe, name, m.layers, n_expert,
                                      has_output=not m.tied,
                                      gqa=m.heads // m.kv_heads), shape)


def norms(m: Model) -> list:
    """output_norm, then each layer's attn_norm and ffn_norm: F32 ones."""
    out = [Tensor("output_norm.weight", F32, (m.dim,), "ones")]
    for i in range(m.layers):
        out += [Tensor(f"blk.{i}.attn_norm.weight", F32, (m.dim,), "ones"),
                Tensor(f"blk.{i}.ffn_norm.weight", F32, (m.dim,), "ones")]
    return out


def tensor_plan(m: Model) -> list:
    plan = [matrix(m, "token_embd.weight", (m.vocab, m.dim))]
    if not m.tied:
        plan.append(matrix(m, "output.weight", (m.vocab, m.dim)))
    for i in range(m.layers):
        plan += [matrix(m, f"blk.{i}.{p}.weight", projection_shape(m, p))
                 for p in PROJECTIONS]
    return plan + norms(m)


def metadata(m: Model) -> dict:
    """The GGUF keys llama.cpp's converter writes for a llama-architecture
    file of these sizes (no tokenizer: the engine then stops on no EOS)."""
    a = "llama"
    return {"general.architecture": a, f"{a}.vocab_size": m.vocab,
            f"{a}.embedding_length": m.dim, f"{a}.block_count": m.layers,
            f"{a}.attention.head_count": m.heads,
            f"{a}.attention.head_count_kv": m.kv_heads,
            f"{a}.feed_forward_length": m.ffn,
            f"{a}.attention.layer_norm_rms_epsilon": m.eps,
            f"{a}.rope.freq_base": m.theta,
            f"{a}.context_length": m.max_seq}


def head_params(m: Model) -> int:
    return m.vocab * m.dim


def matmul_params(m: Model) -> int:
    """P_mm: parameters of every matrix product of a token, the head
    included (the embedding lookup is not a product)."""
    per_layer = sum(r * c for r, c in (projection_shape(m, p)
                                       for p in PROJECTIONS))
    return m.layers * per_layer + head_params(m)


def step_weight_bytes(m: Model, live: int) -> int:
    """Bytes of the quantized matrices one decode step reads once, at any
    number of live slots: every projection and the head as stored (a tied
    head is token_embd)."""
    return sum(nbytes(t.fmt, t.shape) for t in tensor_plan(m)
               if t.fmt != F32
               and not (t.name == "token_embd.weight" and not m.tied))


def attn_flops_per_row(m: Model) -> int:
    """Attention FLOPs per token per context row: q.k and p.v, 2 each per
    head dimension, over every query head of every layer."""
    return 4 * m.layers * m.heads * m.head_dim


def kv_row_bytes(m: Model) -> int:
    """Bytes of one cached token as stored, K and V, every layer: int8
    codes plus one f32 scale per KV head."""
    return 2 * m.layers * m.kv_heads * (m.head_dim + KV_SCALE_BYTES)


def toy(m: Model) -> Model:
    """2 layers at small widths, the same query heads per KV head, tie and
    recipe."""
    heads = 4
    return dataclasses.replace(m, vocab=512, dim=256, layers=2, heads=heads,
                               kv_heads=heads * m.kv_heads // m.heads,
                               head_dim=64, ffn=512, max_seq=256, max_batch=2)
