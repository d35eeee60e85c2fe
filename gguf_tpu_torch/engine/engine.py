"""Serving engine: GGUF model + continuous batching + INT8 KV cache.

Counterpart of the single-device decoder branch of
`gguf_tpu/engine/engine.py:LLM` (`__init__`, `generate`,
`_prefill_chunks`, `_bucket`, `_span_bucket`, and the `_decode` scan as a
Python loop over DECODE_CHUNK steps). A fixed pool of `max_batch` slots
shares one KV cache; new requests take free slots as soon as they open,
and sequences at different depths decode together in one forward step.
Prefill runs per request in power-of-two padded chunks; the cache is
updated in place.

Prompts are token-id lists (the tokenizers are not ported yet). Not
ported yet either: speculative decoding, the prefix cache, chat sessions,
context shift, grammar, penalties, logprobs, stop strings and ids, and
multimodal prompts (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..gguf import GGUFReader
from ..models.llama import MMOpts, forward, fuse_llama_params, init_kv_cache
from ..models.loader import load_llama
from .sampler import SamplerConfig, sample


@dataclass
class GenerationResult:
    prompt_ids: list
    token_ids: list = field(default_factory=list)
    finished: bool = False
    stop_reason: str = ""          # "eos" | "length"
    # batch-level stats shared by every result of one generate() call:
    # wall_s and tokens_per_s are end to end; decode_s / decode_tokens
    # cover the decode chunks alone (host clock, ends in a device sync)
    stats: dict = field(default_factory=dict)


PREFILL_CHUNK = 512   # prompt tokens per prefill call (bounds activations)
DECODE_CHUNK = 8      # decode steps per host sync


class LLM:
    def __init__(self, path: str, *, device, max_batch: int = 8,
                 max_seq: int | None = None, opts: MMOpts = MMOpts()):
        self.device = torch.device(device)
        self.cfg, params = load_llama(path, self.device)
        self.params = fuse_llama_params(params)
        with GGUFReader(path) as r:
            md = r.metadata
        self.eos_id = (int(md.get("tokenizer.ggml.eos_token_id", 2))
                       if "tokenizer.ggml.tokens" in md else -1)
        self.max_batch = max_batch
        self.max_seq = max_seq or self.cfg.max_seq_len
        self.opts = opts
        self.cache = init_kv_cache(self.cfg, max_batch, self.max_seq,
                                   self.device)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _span_bucket(self, need: int) -> int | None:
        """Smallest 128*2^j cache span covering `need` rows (None = whole
        cache)."""
        if self.max_seq < 128:
            return None
        span = 128
        while span < need and span < self.max_seq:
            span *= 2
        return min(span, self.max_seq)

    def _prefill(self, toks: np.ndarray, slot: int, start: int,
                 last_idx: int, span) -> torch.Tensor:
        """One prompt chunk into cache slot `slot` at start..start+t-1;
        returns the logits row of chunk token `last_idx`."""
        cache_1 = [{name: c[slot:slot + 1] for name, c in layer.items()}
                   for layer in self.cache]      # views: writes land in place
        tokens = torch.as_tensor(toks, device=self.device)
        pos = torch.tensor([start], dtype=torch.int32, device=self.device)
        logits, _ = forward(self.params, self.cfg, tokens, pos, cache_1,
                            self.opts, span=span)
        return logits[0, last_idx]

    def _prefill_chunks(self, ids, slot: int, start: int = 0) -> torch.Tensor:
        """Prefill `ids` at start.. in PREFILL_CHUNK pieces with power-of-two
        tail buckets, halved until the padded call fits the cache."""
        n = len(ids)
        if start + n >= self.max_seq:
            raise ValueError(f"prompt of {n} tokens at {start} does not fit "
                             f"max_seq {self.max_seq}")
        ids = np.asarray(ids, np.int32)
        off = 0
        while True:
            tail = n - off
            tp = min(self._bucket(tail), PREFILL_CHUNK)
            while tp > self.max_seq - (start + off):
                tp //= 2
            take = min(tail, tp)
            toks = np.zeros((1, tp), np.int32)
            toks[0, :take] = ids[off:off + take]
            span = self._span_bucket(start + off + tp)
            logits = self._prefill(toks, slot, start + off, take - 1, span)
            off += take
            if off >= n:
                return logits

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor,
                sampler: SamplerConfig, steps: int, span,
                generator) -> torch.Tensor:
        """`steps` decode iterations on the device; (B, steps) token ids."""
        out = []
        for _ in range(steps):
            logits, _ = forward(self.params, self.cfg, tokens[:, None], pos,
                                self.cache, self.opts, span=span)
            tokens = sample(logits[:, 0], sampler, generator)
            out.append(tokens)
            pos = pos + 1
        return torch.stack(out, dim=1)

    def generate(self, prompts, max_new_tokens: int = 64,
                 sampler: SamplerConfig = SamplerConfig(),
                 seed: int = 0) -> list:
        """Generate completions for token-id prompts with continuous
        batching over the slot pool; one GenerationResult per prompt."""
        t_start = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        queue = []
        for i, p in enumerate(prompts):
            ids = list(p)
            if not all(isinstance(e, (int, np.integer)) for e in ids):
                raise NotImplementedError(
                    "prompts are token-id lists: the tokenizers are not "
                    "ported yet (ROADMAP.md)")
            queue.append((i, [int(e) for e in ids]))
        queue.reverse()                   # pop() takes the earliest request
        results = {i: GenerationResult(prompt_ids=ids)
                   for i, ids in reversed(queue)}

        slots: list = [None] * self.max_batch     # request id per slot
        pos = np.zeros(self.max_batch, np.int64)
        last_tok = np.zeros(self.max_batch, np.int64)
        budget = np.zeros(self.max_batch, np.int64)
        eos = self.eos_id
        timing = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0}

        def maybe_finish(s, tok):
            rid = slots[s]
            if rid is None:
                return
            if not (tok == eos or budget[s] <= 0 or pos[s] + 1 >= self.max_seq):
                return
            res = results[rid]
            res.finished = True
            res.stop_reason = "eos" if tok == eos else "length"
            if tok == eos:
                res.token_ids.pop()       # the terminator is not returned
            slots[s] = None

        def admit():
            for s in range(self.max_batch):
                if slots[s] is not None or not queue:
                    continue
                rid, ids = queue.pop()
                t0 = time.perf_counter()
                logits = self._prefill_chunks(ids, s)
                first = int(sample(logits[None, :], sampler, gen)[0])
                timing["prefill_s"] += time.perf_counter() - t0
                slots[s] = rid
                pos[s] = len(ids)
                last_tok[s] = first
                budget[s] = max_new_tokens - 1
                results[rid].token_ids.append(first)
                maybe_finish(s, first)

        admit()
        while any(s is not None for s in slots) or queue:
            live = [s for s in range(self.max_batch) if slots[s] is not None]
            if not live:
                admit()
                continue
            room = min(min(int(budget[s]) + 1, self.max_seq - int(pos[s]) - 1)
                       for s in live)
            steps = 1
            while steps * 2 <= min(DECODE_CHUNK, max(room, 1)):
                steps *= 2
            # inactive slots step at pos = max_seq: their cache inserts are
            # no-ops and their (discarded) outputs are garbage
            active = np.array([s is not None for s in slots])
            pos_dev = np.where(active, pos, self.max_seq)
            span = self._span_bucket(max(int(pos[s]) for s in live) + steps)
            t0 = time.perf_counter()
            ids = self._decode(
                torch.as_tensor(last_tok, device=self.device),
                torch.as_tensor(pos_dev, dtype=torch.int32,
                                device=self.device),
                sampler, steps, span, gen).cpu().numpy()
            timing["decode_s"] += time.perf_counter() - t0
            for j in range(steps):
                for s in range(self.max_batch):
                    if slots[s] is None:
                        continue
                    tok = int(ids[s, j])
                    results[slots[s]].token_ids.append(tok)
                    timing["decode_tokens"] += 1
                    pos[s] += 1
                    last_tok[s] = tok
                    budget[s] -= 1
                    maybe_finish(s, tok)
            admit()

        out = [results[i] for i in sorted(results)]
        wall = time.perf_counter() - t_start
        new_tokens = sum(len(r.token_ids) for r in out)
        stats = {"wall_s": wall, "new_tokens": new_tokens,
                 "tokens_per_s": new_tokens / wall if wall else 0.0, **timing}
        for r in out:
            r.stats = stats
        return out
