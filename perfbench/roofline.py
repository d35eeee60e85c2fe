"""Every FLOP and byte count the per-layer metrics use, and the card's
published peaks.

Work is computed from the traffic and the configuration's shapes, never
from what the implementation launches: a decode step of `live` slots
needs every quantized matrix read once and 2 * P_mm * live FLOPs in the
matrix products, plus attention over each live token's context.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assumes the 700 W power limit; every run prints the card's limit beside
them.
"""

from __future__ import annotations

from .model import PROJECTIONS, Model, nbytes, projection_shape, tensor_plan

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
KV_SCALE_BYTES = 4       # one f32 scale per (token, KV head) row of K or V


def matmul_params(m: Model) -> int:
    """P_mm: parameters of every matrix product of a token, the head
    included (the embedding lookup is not a product)."""
    per_layer = sum(r * c for r, c in (projection_shape(m, p)
                                       for p in PROJECTIONS))
    return m.layers * per_layer + m.vocab * m.dim


def head_params(m: Model) -> int:
    return m.vocab * m.dim


def step_weight_bytes(m: Model) -> int:
    """Bytes of the quantized matrices one decode step reads once: every
    projection and the head as stored (a tied head is token_embd)."""
    total = 0
    for name, fmt, (rows, cols) in tensor_plan(m):
        if name == "token_embd.weight" and not m.tied:
            continue            # looked up by row, not read by a product
        total += nbytes(fmt, rows, cols)
    return total


def attn_flops_per_row(m: Model) -> int:
    """Attention FLOPs per token per context row: q.k and p.v, 2 each per
    head dimension, over every query head of every layer."""
    return 4 * m.layers * m.heads * m.head_dim


def kv_row_bytes(m: Model) -> int:
    """Bytes of one cached token as stored, K and V, every layer: int8
    codes plus one f32 scale per KV head."""
    return 2 * m.layers * m.kv_heads * (m.head_dim + KV_SCALE_BYTES)


def decode_flops(m: Model, tokens: int, context_rows: int) -> float:
    """FLOPs of `tokens` generated tokens whose contexts sum to
    `context_rows` rows (each token attends to itself and every earlier
    position)."""
    return (2.0 * matmul_params(m) * tokens
            + attn_flops_per_row(m) * float(context_rows))


def prefill_flops(m: Model, n: int) -> float:
    """FLOPs a prompt of n tokens needs: the projections for every token,
    the head for the last one (the first generated token), and causal
    attention (token i attends to i + 1 rows)."""
    proj = matmul_params(m) - head_params(m)
    return (2.0 * proj * n + 2.0 * head_params(m)
            + attn_flops_per_row(m) * n * (n + 1) / 2.0)


def mmq_bound_s(m: Model, live: int) -> float:
    """Least time of one decode step's quantized matrix products at `live`
    slots: the larger of the bytes read once and the products' FLOPs."""
    return max(step_weight_bytes(m) / PEAK_HBM_BYTES_PER_S,
               2.0 * matmul_params(m) * live / PEAK_BF16_FLOPS)


def attn_bound_s(m: Model, rows: int) -> float:
    """Least time of decode attention reading `rows` cached rows (summed
    over the slots) as stored."""
    return rows * kv_row_bytes(m) / PEAK_HBM_BYTES_PER_S
