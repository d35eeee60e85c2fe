"""Llama decoder on the port's kernels: RMSNorm -> GQA attention with RoPE
over an INT8 KV cache -> SwiGLU, every projection a fused dequant+matmul.

Counterpart of `gguf_tpu/models/llama.py` (llama arms of `forward`,
`attention`, `mlp`, `moe_mlp` in its mixtral form; `MMOpts`, `linear`,
`embed`, `rms_norm`, the rope helpers, `init_kv_cache`, `_quantize_kv`,
`_cache_update` and `fuse_llama_params` at tp = 1). It keeps the
reference's rounding points: the residual stream is bf16, every `linear`
output is cast to bf16, `rms_norm` computes in f32 and returns bf16, K/V
go to the cache inserts as f32, the t > 16 prefill arm attends in f32,
and logits are bf16 then f32.

PyTorch runs eagerly and the port updates the KV cache IN PLACE:
`forward` returns the same cache list it was given. Nothing in `forward`
reads the device from the host, so a CUDA graph captures it whole; with
`rows` it addresses each sequence's cache row through a device tensor,
so one graph serves every slot.

`host_syncs` counts the port's host-device syncs, by site: the engine's
host copies and reads, each of which adds to it where it makes one. On
the card each count is a sync that torch's sync debug mode reports; the
CPU counts the same sites.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import MMQ
from ..ops.attention import (PALLAS_ATTN_MAX_ELEMS, TILE, cache_rows,
                             decode_attention_update, kv_cache_insert,
                             quantize_kv)
from ..quant.layouts import QuantWeight, concat_m
from .config import LlamaConfig


class MMOpts(NamedTuple):
    """Knobs threaded to every MMQ call. `act_quant` feeds Q8_1-quantized
    activations (llama.cpp's MMQ numerics; with precision "high", the
    integer contract at n <= 16). The reference's TPU tile and sharding
    knobs have no counterpart here."""
    precision: str = "fast"
    act_quant: bool = False
    fuse_glu: bool = True


def linear(w, x: torch.Tensor, opts: MMOpts = MMOpts()) -> torch.Tensor:
    """y = x @ W^T for W (out, in): the MMQ kernel for a QuantWeight, a
    plain f32-accumulated product for float weights; cast to x.dtype."""
    if isinstance(w, QuantWeight):
        return MMQ[w.fmt](w, x, precision=opts.precision,
                          act_quant=opts.act_quant).to(x.dtype)
    return (x.float() @ w.to(x.dtype).float().T).to(x.dtype)


def embed(table, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (float32); dequantizes only the selected rows
    of a quantized table."""
    flat = ids.reshape(-1)
    if isinstance(table, QuantWeight):
        out = table.take_rows(flat).dequantize()
    else:
        out = table[flat].float()
    return out.reshape(*ids.shape, -1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _freq_factors(factors: tuple, device: torch.device) -> torch.Tensor:
    """A config's rope frequency divisors on `device`, copied there once:
    the decode step then reads nothing from the host (a CUDA graph
    captures it)."""
    return torch.tensor(factors, dtype=torch.float32, device=device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scale: float = 1.0, *, kind: str = "linear",
                 freq_factors: tuple | None = None):
    """(...,) int positions -> cos/sin (..., head_dim/2) float32. Linear
    position interpolation (`scale` > 1) or none; frequencies in f32."""
    if kind not in ("none", "linear"):
        raise NotImplementedError(
            f"rope scaling {kind!r} is not ported yet: ROADMAP.md, queue 1")
    dev = positions.device
    freqs = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=dev) / head_dim)
    if freq_factors is not None:
        freqs = freqs / _freq_factors(tuple(freq_factors), dev)
    angles = (positions.float() / scale)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def rope_for_cfg(positions: torch.Tensor, cfg: LlamaConfig):
    return rope_cos_sin(positions, cfg.rope_dim or cfg.head_dim,
                        cfg.rope_theta, cfg.rope_scale,
                        kind=cfg.rope_scaling_kind,
                        freq_factors=cfg.rope_freq_factors)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               neox: bool = False) -> torch.Tensor:
    """Rotary embedding; x (..., H, hd), cos/sin broadcastable to
    (..., 1, hd/2). neox=False rotates consecutive pairs (2j, 2j+1)
    (llama.cpp ROPE_TYPE_NORM), neox=True rotates (j, j+hd/2). Computed as
    x*cos2 + partner*sin2 in f32 like the reference's permute-matrix form
    (the same products and sums)."""
    xf = x.float()
    hd = xf.shape[-1]
    if neox:
        cos2 = torch.cat([cos, cos], dim=-1)
        sin2 = torch.cat([sin, sin], dim=-1)
        partner = torch.cat([-xf[..., hd // 2:], xf[..., :hd // 2]], dim=-1)
    else:
        cos2 = torch.stack([cos, cos], dim=-1).reshape(*cos.shape[:-1], hd)
        sin2 = torch.stack([sin, sin], dim=-1).reshape(*sin.shape[:-1], hd)
        partner = torch.stack([-xf[..., 1::2], xf[..., 0::2]],
                              dim=-1).reshape(xf.shape)
    return (xf * cos2 + partner * sin2).to(x.dtype)


host_syncs = 0

# the expert layers `moe_mlp` ran and the rows its expert products ran
# over, added where it runs: in eager runs and in a graph's capture, never
# in a replay (`ChunkGraphs` keeps each prefill key's share)
moe_layers_run = 0
expert_rows = 0

# --------------------------------------------------------- INT8 KV cache ---


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int | None,
                  device) -> list:
    """Per-layer INT8 K/V caches (B, KVH, S, hd) with per-row f32 scales."""
    s = max_seq or cfg.max_seq_len
    shape = (batch, cfg.n_kv_heads, s, cfg.head_dim)
    return [{
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    } for _ in range(cfg.n_layers)]


def _cache_update(cache_l: dict, new_k: torch.Tensor, new_v: torch.Tensor,
                  pos: torch.Tensor, rows: torch.Tensor | None = None) -> dict:
    """Write T new rows per sequence at pos (the long-prefill arm, T > 16),
    in place, into cache batch row rows[b] (row b without `rows`): one
    scatter per tensor at flat indices computed on the device. The start
    clamps to [0, S - T] like the reference's dynamic_update_slice;
    callers keep pos + T <= S."""
    qk, sk = quantize_kv(new_k)
    qv, sv = quantize_kv(new_v)
    b, kvh, t, hd = new_k.shape
    s = cache_l["k"].shape[2]
    dev = pos.device
    if rows is None:
        rows = torch.arange(b, device=dev)
    start = pos.long().clamp(0, s - t)
    at = ((rows.long()[:, None, None] * kvh
           + torch.arange(kvh, device=dev)[None, :, None]) * s
          + start[:, None, None]
          + torch.arange(t, device=dev)[None, None, :]).reshape(-1)
    cache_l["k"].view(-1, hd).index_copy_(0, at, qk.reshape(-1, hd))
    cache_l["v"].view(-1, hd).index_copy_(0, at, qv.reshape(-1, hd))
    cache_l["k_scale"].view(-1).index_copy_(0, at, sk.reshape(-1))
    cache_l["v_scale"].view(-1).index_copy_(0, at, sv.reshape(-1))
    return cache_l


# ----------------------------------------------------------- transformer ---


def attention(layer, x, cfg: LlamaConfig, cache_l: dict, pos, opts: MMOpts,
              rope=None, span: int | None = None, rows=None):
    """GQA attention over the INT8 cache. x (B, T, dim); pos (B,) start
    positions; span bounds the cache rows read (every pos + T <= span);
    rows (B,) int32, where given, the cache batch row of each sequence
    (else row b).

    The reference's three routes, on its conditions: within the
    single-tile envelope (KVH * span * hd <= PALLAS_ATTN_MAX_ELEMS) and
    t <= 8, cache insert + K4; past it at t = 1 with span a multiple of
    256, cache insert + K9 (tiled flash-decoding); on the card both are one
    launch at t = 1 with the insert fused in (`decode_attention_update`).
    Otherwise the K3 insert (t <= 16) or the `_cache_update` scatter, then
    plain f32 attention over the span."""
    b, t, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    xf = x.reshape(b * t, -1)
    if "wqkv" in layer:
        qkv = linear(layer["wqkv"], xf, opts)
        q = qkv[:, :h * hd].reshape(b, t, h, hd)
        k = qkv[:, h * hd:(h + kvh) * hd].reshape(b, t, kvh, hd)
        v = qkv[:, (h + kvh) * hd:].reshape(b, t, kvh, hd)
    else:
        q = linear(layer["wq"], xf, opts).reshape(b, t, h, hd)
        k = linear(layer["wk"], xf, opts).reshape(b, t, kvh, hd)
        v = linear(layer["wv"], xf, opts).reshape(b, t, kvh, hd)

    tok_pos = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
    cos, sin = rope if rope is not None else rope_for_cfg(tok_pos, cfg)
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :], cfg.rope_neox)
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :], cfg.rope_neox)

    ck, cks, cv, cvs = (cache_l["k"], cache_l["k_scale"], cache_l["v"],
                        cache_l["v_scale"])
    s_cache = ck.shape[2]
    span_eff = s_cache if span is None else min(span, s_cache)
    if (t <= 8 and kvh * span_eff * hd <= PALLAS_ATTN_MAX_ELEMS
            or t == 1 and span_eff % TILE == 0):
        out = decode_attention_update(
            q.transpose(1, 2), k.transpose(1, 2).float(),
            v.transpose(1, 2).float(), ck, cks, cv, cvs, pos, t=t,
            precision=opts.precision, span=span_eff, rows=rows)[0]
        out = out.transpose(1, 2).reshape(b * t, h * hd)
    else:
        if t <= 16:
            kv_cache_insert(k.transpose(1, 2).float(), v.transpose(1, 2).float(),
                            ck, cks, cv, cvs, pos, rows=rows)
        else:
            _cache_update(cache_l, k.transpose(1, 2), v.transpose(1, 2), pos,
                          rows)
        s = span_eff
        ck, cks, cv, cvs = (cache_rows(c, rows, s) for c in (ck, cks, cv, cvs))
        k_all = ck.float() * cks[..., None]
        v_all = cv.float() * cvs[..., None]
        g = h // kvh
        qg = q.transpose(1, 2).reshape(b, kvh, g * t, hd)
        scores = qg.float() @ k_all.transpose(-1, -2)
        scores = scores.reshape(b, kvh, g, t, s) / math.sqrt(hd)
        causal = (torch.arange(s, device=x.device)[None, None, :]
                  <= tok_pos[:, :, None])                          # (B, T, S)
        scores = scores.masked_fill(~causal[:, None, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = probs @ v_all[:, :, None]                            # (B,KVH,G,T,hd)
        out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b * t, h * hd)
    proj = linear(layer["wo"], out.to(x.dtype), opts)
    return proj.reshape(b, t, -1), cache_l


def mlp(layer, x, opts: MMOpts, act_fn: str = "silu"):
    """Gated MLP; with fused gate_up and a Q4_K down weight, the GLU runs
    inside the down kernel (h = act(gate) * up in f32; under act_quant
    inside the Q8_1 quantizer that feeds it). Other down weights take
    act(gate) rounded to bf16, times up."""
    b, t, _ = x.shape
    xf = x.reshape(b * t, -1)
    if "gate_up" in layer:
        gu = linear(layer["gate_up"], xf, opts)
        down_w = layer["down"]
        if (opts.fuse_glu and isinstance(down_w, QuantWeight)
                and down_w.fmt == "q4_k" and act_fn in ("silu", "gelu")
                and gu.shape[-1] == 2 * down_w.shape[1]):
            down = MMQ["q4_k"](down_w, gu, precision=opts.precision,
                               glu=act_fn, act_quant=opts.act_quant
                               ).to(x.dtype)
            return down.reshape(b, t, -1)
        g, u = gu.chunk(2, dim=-1)
    else:
        g = linear(layer["gate"], xf, opts)
        u = linear(layer["up"], xf, opts)
    gf = g.float()
    act = (F.silu(gf) if act_fn == "silu"
           else F.gelu(gf, approximate="tanh")).to(x.dtype) * u
    return linear(layer["down"], act, opts).reshape(b, t, -1)


def experts(layer) -> list:
    """A routed layer's experts as dense FFN layers for `mlp`: expert e's
    rows of each stack (views, no copy), its gate and up fused as
    "gate_up" where `fuse_llama_params` paired them."""
    n = layer["gate_inp"].shape[0]

    def part(w, e):
        m = w.shape[0] // n
        return w.row_block(e * m, (e + 1) * m)

    names = (("gate_up", "down") if "gate_up_exps" in layer
             else ("gate", "up", "down"))
    return [{nm: part(layer[nm + "_exps"], e) for nm in names}
            for e in range(n)]


def routing_weights(layer, xf: torch.Tensor, cfg: LlamaConfig):
    """(N, E) f32 weights of each row's experts: the router's f32 logits
    of the rows xf (N, dim), a softmax over all E, the `n_experts_used`
    largest kept (an index compare, no scatter) and renormalised to sum
    1, zero elsewhere."""
    logits = xf.float() @ layer["gate_inp"].float().T
    probs = torch.softmax(logits, dim=-1)
    top = torch.topk(probs, cfg.n_experts_used, dim=-1).indices
    sel = (top[..., None] == torch.arange(probs.shape[-1],
                                          device=xf.device)).any(1)
    w = torch.where(sel, probs, 0.0)
    return w / w.sum(dim=-1, keepdim=True)


def moe_mlp(layer, x, cfg: LlamaConfig, opts: MMOpts):
    """Mixture-of-experts FFN (mixtral family), as the JAX package's
    `moe_mlp` computes it: router logits in f32 from the bf16 normed
    input, a softmax over all E experts, the top `n_experts_used` kept
    and renormalised to sum 1 (zero elsewhere), and the weighted sum in
    f32, in expert order, of every expert's SwiGLU (`mlp`: K1's fused
    gate_up, the GLU fused into a Q4_K down kernel), cast to bf16.

    Evaluation is dense per expert: each expert runs over every row, and
    its zero weight drops it where the token was not routed to it. So the
    routing reads nothing back to the host, launches the same kernels
    whatever the tokens choose, and sums without atomics: a CUDA graph
    captures it and a replay equals its eager run bit for bit. Adds the
    layer to `moe_layers_run` and each expert's rows to `expert_rows`."""
    global moe_layers_run, expert_rows
    b, t, d = x.shape
    w = routing_weights(layer, x.reshape(b * t, d), cfg)
    acc = torch.zeros((b * t, d), dtype=torch.float32, device=x.device)
    moe_layers_run += 1
    for e, expert in enumerate(experts(layer)):
        out = mlp(expert, x, opts, cfg.act_fn).reshape(b * t, d)
        expert_rows += b * t
        acc = acc + w[:, e:e + 1] * out.float()
    return acc.to(x.dtype).reshape(b, t, d)


def fuse_llama_params(params: dict) -> dict:
    """Fuse each layer's Q/K/V and gate/up projections along M (one MMQ
    launch instead of three and two; only same-format quantized groups
    fuse); in a routed layer, each expert's gate and up rows are paired
    into one stack "gate_up_exps" (expert e's gate_up its rows e*2M..
    (e+1)*2M). An untied quantized embedding table of at most 600 MiB as
    f32 is kept dequantized, so a lookup is a row gather."""

    def fusable(ws):
        return (all(isinstance(w, QuantWeight) for w in ws)
                and len({w.fmt for w in ws}) == 1)

    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        if "wq" in layer and fusable([layer["wq"], layer["wk"], layer["wv"]]):
            layer["wqkv"] = concat_m([layer.pop("wq"), layer.pop("wk"),
                                      layer.pop("wv")])
        if "gate" in layer and fusable([layer["gate"], layer["up"]]):
            layer["gate_up"] = concat_m([layer.pop("gate"), layer.pop("up")])
        if ("gate_exps" in layer
                and fusable([layer["gate_exps"], layer["up_exps"]])):
            pairs = [p for ex in experts(layer)
                     for p in (ex["gate"], ex["up"])]
            layer["gate_up_exps"] = concat_m(pairs)
            del layer["gate_exps"], layer["up_exps"]
        layers.append(layer)
    out = {**params, "layers": layers}
    emb = out.get("token_embd")
    if (isinstance(emb, QuantWeight) and out.get("output") is not emb
            and emb.shape[0] * emb.shape[1] * 4 <= 600 * 2**20):
        out["token_embd"] = emb.dequantize()
    return out


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
            pos: torch.Tensor, cache: list, opts: MMOpts = MMOpts(),
            span: int | None = None, rows: torch.Tensor | None = None):
    """Run T tokens through the decoder: (logits (B, T, vocab) f32, cache).
    tokens (B, T) int; pos (B,) start positions (per-slot, continuous
    batching); span bounds the cache rows attention reads; rows (B,)
    int32 on the device, where given, the cache batch row each sequence
    reads and writes (a cache of any batch), else row b."""
    x = embed(params["token_embd"], tokens).to(torch.bfloat16)
    tok_pos = pos[:, None] + torch.arange(tokens.shape[1],
                                          device=pos.device)[None, :]
    rope = rope_for_cfg(tok_pos, cfg)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        attn_out, cache[i] = attention(layer, h, cfg, cache[i], pos, opts,
                                       rope=rope, span=span, rows=rows)
        x = x + attn_out
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + (moe_mlp(layer, h, cfg, opts) if "gate_inp" in layer
                 else mlp(layer, h, opts, cfg.act_fn))
    x = rms_norm(x, params["output_norm"], cfg.norm_eps)
    b, t, _ = x.shape
    logits = linear(params["output"], x.reshape(b * t, -1), opts)
    logits = logits[:, :cfg.vocab_size].reshape(b, t, -1).float()
    return logits, cache
