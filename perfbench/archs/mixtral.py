"""The mixtral GGUF schema (llama.cpp's LLM_ARCH_LLAMA with experts, as
its converter writes Mixtral): llama's attention, and in every layer a
router `ffn_gate_inp` (E, dim) in F32 over `num_local_experts` SwiGLU
experts stored as three 3-D stacks `ffn_{gate,up,down}_exps` (E, M, K),
of which each token uses `num_experts_per_tok`.

File order: token_embd, output, each layer's four attention
projections, its router and its three stacks, then the norms
(output_norm, each layer's attn_norm and ffn_norm), all ones.

The router is a normal draw from the seed with std ROUTER_LOGIT_STD /
sqrt(hidden_size): the router's input is RMS-normed (RMS 1, norm
weights ones), so its logits have std ROUTER_LOGIT_STD. At 2.0 over 8
experts the top two take 0.77 of the softmax on average, the first
0.72 of the pair after renormalisation, and the median gap between the
second and third logit is 0.57: a router that prefers, as a trained one
does, not one that ties (at 0.5, the std of the projections' draw, the
softmax is near uniform and the pair's weights near 0.5 each).
"""

from __future__ import annotations

import dataclasses

from ..model import F32, Model, Tensor, nbytes
from . import llama

ROUTER_LOGIT_STD = 2.0
ATTENTION = ("attn_q", "attn_k", "attn_v", "attn_output")


def experts(m: Model) -> tuple:
    """(experts per layer, experts per token)."""
    return (int(m.config["num_local_experts"]),
            int(m.config["num_experts_per_tok"]))


def experts_hit(n_expert: int, used: int, tokens: int) -> float:
    """Expected number of a layer's `n_expert` experts that `tokens`
    tokens, each routed to `used` of them uniformly, reach at least once."""
    return n_expert * (1.0 - (1.0 - used / n_expert) ** tokens)


def stack_shapes(m: Model) -> tuple:
    """(name, (E, M, K)) of a layer's three expert stacks."""
    e, _ = experts(m)
    return (("ffn_gate_exps", (e, m.ffn, m.dim)),
            ("ffn_up_exps", (e, m.ffn, m.dim)),
            ("ffn_down_exps", (e, m.dim, m.ffn)))


def tensor_plan(m: Model) -> list:
    e, _ = experts(m)
    plan = [llama.matrix(m, "token_embd.weight", (m.vocab, m.dim), e),
            llama.matrix(m, "output.weight", (m.vocab, m.dim), e)]
    for i in range(m.layers):
        p = f"blk.{i}."
        plan += [llama.matrix(m, f"{p}{n}.weight",
                              llama.projection_shape(m, n), e)
                 for n in ATTENTION]
        plan.append(Tensor(f"{p}ffn_gate_inp.weight", F32, (e, m.dim),
                           ROUTER_LOGIT_STD / m.dim ** 0.5))
        plan += [llama.matrix(m, f"{p}{n}.weight", shape, e)
                 for n, shape in stack_shapes(m)]
    return plan + llama.norms(m)


def metadata(m: Model) -> dict:
    e, k = experts(m)
    return {**llama.metadata(m), "llama.expert_count": e,
            "llama.expert_used_count": k}


head_params = llama.head_params
attn_flops_per_row = llama.attn_flops_per_row
kv_row_bytes = llama.kv_row_bytes


def matmul_params(m: Model) -> int:
    """P_mm of one token: the attention projections, the router, the
    `num_experts_per_tok` experts it is routed to, and the head."""
    e, k = experts(m)
    attn = sum(r * c for r, c in (llama.projection_shape(m, n)
                                  for n in ATTENTION))
    return (m.layers * (attn + e * m.dim + k * 3 * m.ffn * m.dim)
            + head_params(m))


def step_weight_bytes(m: Model, live: int) -> float:
    """Bytes one decode step of `live` slots reads once: the attention
    projections, the routers and the head as stored, and of each expert
    stack the share of experts that `live` tokens reach
    (`experts_hit`)."""
    e, k = experts(m)
    total = 0.0
    for t in tensor_plan(m):
        if t.name == "token_embd.weight" or t.init == "ones":
            continue
        share = experts_hit(e, k, live) / e if "_exps" in t.name else 1
        total += nbytes(t.fmt, t.shape) * share
    return total


def toy(m: Model) -> Model:
    """llama's toy widths at 2 layers, 4 experts, top 2."""
    return dataclasses.replace(
        llama.toy(m), layers=2,
        config={**m.config, "num_local_experts": 4,
                "num_experts_per_tok": 2})
