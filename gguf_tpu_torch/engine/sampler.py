"""Token samplers: greedy, temperature, top-k, top-p, min-p (batched).

Counterpart of `gguf_tpu/engine/sampler.py:sample`. Randomness comes from
an explicit `torch.Generator` on the logits' device; it draws other
numbers than the reference's jax.random keys, so only greedy output is
comparable token for token. Every op runs on the device with no host
read or host-to-device copy, so a CUDA graph can capture `sample` and
`logprobs` (the engine's decode chunk). Penalties, DRY, mirostat, XTC, typical-p,
top-n-sigma and logit bias are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled
    min_p: float = 0.0         # 0 => disabled (keep p >= min_p * max p)


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64, the reference's filter order
    (top-k, then min-p, then top-p)."""
    logits = logits.float()
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    neg = float("-inf")        # a Python scalar: no host-to-device copy
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, neg)
    if cfg.min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        cutoff = cfg.min_p * probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < cutoff, neg)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix whose cumulative probability >= top_p
        cut_idx = torch.argmax((cum >= cfg.top_p).int(), dim=-1)
        cutoff = sorted_logits.gather(-1, cut_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def logprobs(logits: torch.Tensor, chosen: torch.Tensor, k: int):
    """The reference's per-step logprobs (`gguf_tpu/engine/engine.py`,
    `_decode`'s scan): log_softmax of the f32 logits (B, V), the chosen
    tokens' (B,) entries, and the top-k (ids (B, k) int32, logprobs
    (B, k)), largest first."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    top_lp, top_id = torch.topk(lp, k, dim=-1)
    return (lp.gather(-1, chosen[:, None].long())[:, 0],
            top_id.to(torch.int32), top_lp)
