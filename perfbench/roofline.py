"""Every FLOP and byte count the per-layer metrics use, and the card's
published peaks.

Work is computed from the traffic and the configuration's shapes, never
from what the implementation launches: a decode step of `live` slots
needs the quantized matrices it reaches read once and 2 * P_mm * live
FLOPs in the matrix products, plus attention over each live token's
context. The counts that depend on the architecture (P_mm, the head, the
bytes a step reads, attention per context row, a cached row) come from
its module, `perfbench/archs/<name>.py`.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assumes the 700 W power limit; every run prints the card's limit beside
them.
"""

from __future__ import annotations

from .model import Model, arch

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
KV_SCALE_BYTES = 4       # one f32 scale per (token, KV head) row of K or V


def matmul_params(m: Model) -> int:
    """P_mm: parameters of the matrix products one token uses, the head
    included (the embedding lookup is not a product; of routed experts
    only those a token is routed to)."""
    return arch(m).matmul_params(m)


def head_params(m: Model) -> int:
    return arch(m).head_params(m)


def step_weight_bytes(m: Model, live: int) -> float:
    """Bytes of the quantized matrices one decode step of `live` slots
    reads once (of routed experts, those the step's tokens reach)."""
    return arch(m).step_weight_bytes(m, live)


def attn_flops_per_row(m: Model) -> int:
    """Attention FLOPs per token per context row."""
    return arch(m).attn_flops_per_row(m)


def kv_row_bytes(m: Model) -> int:
    """Bytes of one cached token as stored, K and V, every layer."""
    return arch(m).kv_row_bytes(m)


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
    return max(step_weight_bytes(m, live) / PEAK_HBM_BYTES_PER_S,
               2.0 * matmul_params(m) * live / PEAK_BF16_FLOPS)


def attn_bound_s(m: Model, rows: int) -> float:
    """Least time of decode attention reading `rows` cached rows (summed
    over the slots) as stored."""
    return rows * kv_row_bytes(m) / PEAK_HBM_BYTES_PER_S
