"""Plain float32 reference of a mixtral-architecture GGUF model, for the
configurations whose `reference` is "mixtral".

Written from the Mixtral paper (arXiv:2401.04088, eq. 1-2) and
llama.cpp's `build_moe_ffn`, independent of the port: it imports
nothing of `gguf_tpu_torch` and takes only the tensors the harness made
from the seed. The attention half of each layer is the llama
reference's (`references/llama.py`: its dequantizers, RMSNorm, rotary
embedding, the served INT8 K/V rounding and causal grouped-query
attention). The FFN half: the router's logits x W_g^T, a softmax over
all experts, the `num_experts_per_tok` largest kept and their weights
renormalised to sum 1, and the weighted sum of those experts'
SwiGLUs, silu(x W_1^T) * (x W_3^T) W_2^T. Every product runs in
float32 with TF32 off.

Departures from the paper, each the served program's:
- The weights are random GGUF blocks dequantized (llama.cpp's
  dequantizers), not the trained ones.
- K and V are rounded through the served INT8 cache (one absmax/127
  scale per token and KV head).
- Rotary embedding in llama.cpp's NORM order (pairs 2j, 2j + 1), the
  order its converter permutes the q/k weights into.
- The paper takes the softmax over the top-2 logits; a softmax over all
  experts renormalised over the top 2 is the same weights (llama.cpp's
  and Hugging Face's form).
- The router and the expert sum run in float32 (Hugging Face's
  bfloat16 router takes only its softmax in float32).

It runs after the window, layer by layer over the sampled requests and
expert by expert within a layer, so that its memory stays small: one
layer's attention matrices and one expert's three matrices dequantized
at a time.
"""

from __future__ import annotations

import torch

from ..archs.mixtral import ATTENTION, experts
from ..model import Model
from .llama import (_gap, _no_tf32, attention, dequant, fp8_rows, int8_rows,
                    rms_norm, rope_norm)


def served_gaps(m: Model, weights: dict, requests: list, device) -> list:
    """For each (prompt ids, served ids) request: the gap by which each
    served token's logit lies below the reference's best at its position
    (0 where it is the reference's argmax), as a float64 numpy array."""
    with _no_tf32():
        rows = _served_logits(m, weights, requests, torch.device(device))
        out = []
        for (_, served), logits in zip(requests, rows):
            chosen = torch.tensor(list(served), dtype=torch.long,
                                  device=logits.device)
            out.append(_gap(logits, chosen))
        return out


def control_gaps(m: Model, weights: dict, requests: list, device) -> list:
    """The control: the reference in the program's place with every
    product's activations rounded to float8 e4m3 (the router's input
    too), over the same prompts and served tokens; at each position the
    gap below the f32 reference's best of the token the control puts
    first."""
    with _no_tf32():
        dev = torch.device(device)
        exact = _served_logits(m, weights, requests, dev)
        low = _served_logits(m, weights, requests, dev, act=fp8_rows)
        return [_gap(e, lo.argmax(-1)) for e, lo in zip(exact, low)]


def route(m: Model, h: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(tokens, E) weights of each token's experts: softmax over every
    expert's logit, the `num_experts_per_tok` largest kept and
    renormalised to sum 1, zero elsewhere."""
    _, k = experts(m)
    probs = torch.softmax(h @ router.T, dim=-1)
    top = torch.topk(probs, k, dim=-1)
    w = torch.zeros_like(probs).scatter(-1, top.indices, top.values)
    return w / w.sum(-1, keepdim=True)


def _served_logits(m: Model, weights: dict, requests: list, device,
                   act=lambda x: x) -> list:
    """Each request's logits (f32) at the positions that predict its
    served tokens; `act` rounds every product's activations."""
    n_expert, _ = experts(m)
    seqs = [torch.tensor(list(p) + list(s[:-1]), dtype=torch.long,
                         device=device) for p, s in requests]
    xs = [dequant(weights["token_embd.weight"], t) for t in seqs]
    for i in range(m.layers):
        p = f"blk.{i}."
        w = {n: dequant(weights[f"{p}{n}.weight"])
             for n in (*ATTENTION, "attn_norm", "ffn_norm", "ffn_gate_inp")}
        hs, routes = [], []
        for j, t in enumerate(seqs):
            x = xs[j]
            pos = torch.arange(len(t), device=device)
            h = act(rms_norm(x, m.eps, w["attn_norm"]))
            q = (h @ w["attn_q"].T).reshape(len(t), m.heads, m.head_dim)
            k = (h @ w["attn_k"].T).reshape(len(t), m.kv_heads, m.head_dim)
            v = (h @ w["attn_v"].T).reshape(len(t), m.kv_heads, m.head_dim)
            q, k = rope_norm(q, pos, m.theta), rope_norm(k, pos, m.theta)
            o = attention(m, q, int8_rows(k), int8_rows(v))
            xs[j] = x + act(o) @ w["attn_output"].T
            hs.append(act(rms_norm(xs[j], m.eps, w["ffn_norm"])))
            routes.append(route(m, hs[-1], w["ffn_gate_inp"]))
        del w
        ffn = [torch.zeros_like(x) for x in xs]
        for e in range(n_expert):
            gate, up, down = (dequant(weights[f"{p}{n}.weight"],
                                      slice(e, e + 1))[0]
                              for n in ("ffn_gate_exps", "ffn_up_exps",
                                        "ffn_down_exps"))
            for j, h in enumerate(hs):
                mid = torch.nn.functional.silu(h @ gate.T) * (h @ up.T)
                ffn[j] += routes[j][:, e:e + 1] * (act(mid) @ down.T)
            del gate, up, down
        xs = [x + f for x, f in zip(xs, ffn)]
    head = dequant(weights["output.weight"])
    norm = dequant(weights["output_norm.weight"])
    return [act(rms_norm(x[len(p) - 1:], m.eps, norm)) @ head.T
            for (p, _), x in zip(requests, xs)]
