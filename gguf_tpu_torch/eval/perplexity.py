"""Perplexity of a token stream, scored the way llama.cpp's `perplexity`
tool scores it: non-overlapping windows of `window` tokens, each token's
next-token NLL given its window prefix, and only the second half of each
window counted (every scored token has at least window/2 tokens of
context), ppl = exp(mean NLL).

Counterpart of `gguf_tpu/eval/perplexity.py` (`sequence_nll`,
`perplexity`, `perplexity_of_gguf`): the same windows, the same
accounting, scored through the standard `forward` prefill path, on the
card unless the caller asks for the CPU. The JAX package pads the last batch of windows with
empty rows to reuse one compiled program; eager PyTorch needs no padding,
and the rows are independent, so the sums are the same.

`act_quant=True` scores with Q8_1-quantized activations, llama.cpp's MMQ
numerics, under which "perplexity within 0.01 of llama.cpp" is defined;
the default scores the bf16-activation path `LLM` serves by default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import (LlamaConfig, MMOpts, forward, fuse_llama_params,
                      init_kv_cache, load_llama)


def _window_nll(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                n_valid: torch.Tensor, opts: MMOpts, first: int):
    """NLL sum and count over one (B, W) batch of windows; positions
    first .. n_valid-1 are scored."""
    b, w = tokens.shape
    dev = tokens.device
    cache = init_kv_cache(cfg, b, w, dev)
    logits, _ = forward(params, cfg, tokens,
                        torch.zeros(b, dtype=torch.int32, device=dev),
                        cache, opts)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    idx = torch.arange(1, w, device=dev)[None, :]
    valid = (idx >= first) & (idx < n_valid[:, None])
    return float((nll * valid).sum()), int(valid.sum())


def sequence_nll(params: dict, cfg: LlamaConfig, token_ids, *,
                 window: int = 512, batch: int = 8,
                 opts: MMOpts = MMOpts(), full_window: bool = False):
    """(total NLL, token count) over a token stream, on the device the
    params lie on. full_window=True scores positions 1.. of each window
    instead of its second half (not comparable to llama.cpp). A trailing
    window shorter than 2 tokens is skipped."""
    dev = params["output_norm"].device
    ids = np.asarray(token_ids, dtype=np.int64).reshape(-1)
    window = min(window, cfg.max_seq_len)
    n_win = len(ids) // window + (1 if len(ids) % window > 1 else 0)
    if n_win == 0:
        raise ValueError(f"need at least 2 tokens, got {len(ids)}")
    first = 1 if full_window else max(1, window // 2)
    total, count = 0.0, 0
    for start in range(0, n_win, batch):
        rows = min(batch, n_win - start)
        toks = np.zeros((rows, window), np.int64)
        nval = np.zeros(rows, np.int64)
        for r in range(rows):
            lo = (start + r) * window
            chunk = ids[lo:lo + window]
            toks[r, :len(chunk)] = chunk
            nval[r] = len(chunk)
        s, c = _window_nll(params, cfg, torch.from_numpy(toks).to(dev),
                           torch.from_numpy(nval).to(dev), opts, first)
        total += s
        count += c
    return total, count


def perplexity(params: dict, cfg: LlamaConfig, token_ids, **kw) -> float:
    """exp(mean next-token NLL) over the stream."""
    total, count = sequence_nll(params, cfg, token_ids, **kw)
    return float(np.exp(total / max(count, 1)))


def perplexity_of_gguf(path: str, token_ids, *, device="cuda",
                       act_quant: bool = False, **kw) -> float:
    """Load a GGUF checkpoint onto `device` (the card unless the caller
    asks for the CPU) and score a token stream."""
    cfg, params = load_llama(path, device)
    params = fuse_llama_params(params)
    kw.setdefault("opts", MMOpts(act_quant=act_quant))
    return perplexity(params, cfg, token_ids, **kw)
