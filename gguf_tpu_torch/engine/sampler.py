"""Token samplers: greedy, temperature, top-k, top-p, min-p (batched).

Counterpart of `gguf_tpu/engine/sampler.py:sample`. Randomness comes from
an explicit `torch.Generator` on the logits' device; it draws other
numbers than the reference's jax.random keys, so only greedy output is
comparable token for token. Penalties, DRY, mirostat, XTC, typical-p,
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
    neg = torch.tensor(float("-inf"), device=logits.device)
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if cfg.min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        cutoff = cfg.min_p * probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < cutoff, neg, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix whose cumulative probability >= top_p
        cut_idx = torch.argmax((cum >= cfg.top_p).int(), dim=-1)
        cutoff = sorted_logits.gather(-1, cut_idx[:, None])
        logits = torch.where(logits < cutoff, neg, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
