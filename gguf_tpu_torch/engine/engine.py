"""Serving engine: GGUF model + continuous batching + INT8 KV cache.

Counterpart of the single-device decoder branch of
`gguf_tpu/engine/engine.py:LLM` (`__init__`, `generate` with its
`decode_chunk`, `stop_at_eos`, `stop_ids`, `on_tokens` and `logprobs`
arguments, `_prefill_chunks`, `_bucket`, `_span_bucket`, and the jitted
`_decode` scan as `_decode`; on the card each decode chunk and each
prefill chunk is one CUDA graph replay, `decode_graph.ChunkGraphs`). A
fixed pool of `max_batch` slots shares one KV cache; new requests take
free slots as soon as they open, and sequences at different depths
decode together in one forward step. Prefill runs per request in
power-of-two padded chunks with no host read inside a chunk; the cache
is updated in place. `LLM.tracer` (`trace.py`), off by default, records
the spans of each call.

Prompts are token-id lists (the tokenizers are not ported yet). Not
ported yet either: speculative decoding, the prefix cache, chat sessions,
context shift, grammar, penalties, stop strings, and multimodal prompts
(ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..gguf import GGUFReader
from ..models import llama
from ..models.llama import MMOpts, forward, fuse_llama_params, init_kv_cache
from ..models.loader import load_llama
from .decode_graph import Chunk, ChunkGraphs
from .sampler import SamplerConfig, logprobs as chosen_logprobs, sample
from .trace import Tracer


@dataclass
class GenerationResult:
    prompt_ids: list
    token_ids: list = field(default_factory=list)
    finished: bool = False
    stop_reason: str = ""          # "eos" | "stop" (stop_ids) | "length"
    # batch-level stats shared by every result of one generate() call:
    # wall_s is end to end; prefill_s covers each request's prefill and
    # first token, decode_s / decode_tokens the decode chunks alone (host
    # clock, each ends in a device sync), capture_s the part of both that
    # captured CUDA graphs; prefill_tokens counts the prompt tokens,
    # prefill_widths the prefill chunks by padded width ({t: chunks}),
    # prefill_replays the chunks that replayed a graph an earlier chunk
    # captured (on the CPU: ran on the static buffers of a key run
    # before), prefill_syncs the host-device syncs inside prefill_s;
    # prefill_moe_routed, the token-expert pairs the prefills' routed FFN
    # needs (k per real prompt token per expert layer that `moe_mlp` ran),
    # and prefill_expert_rows, the rows its expert products ran over (as
    # `moe_mlp` counts them, per chunk key: `ChunkGraphs.prefill_moe`),
    # both zero for a dense model; decode_finite is False if any decode
    # step's logits were not finite
    stats: dict = field(default_factory=dict)
    # when generate(logprobs=k): one {"logprob": f, "top": [(id, lp), ...]}
    # entry per generated token
    logprobs: list | None = None


PREFILL_CHUNK = 512   # prompt tokens per prefill call (bounds activations)
DECODE_CHUNK = 8      # default decode steps per host sync (generate's
                      # decode_chunk)


class LLM:
    """A GGUF model served on `device`: the card unless the caller asks
    for the CPU."""

    def __init__(self, path: str, *, device="cuda", max_batch: int = 8,
                 max_seq: int | None = None, opts: MMOpts = MMOpts()):
        self.device = torch.device(device)
        self.cfg, params = load_llama(path, self.device)
        self.params = fuse_llama_params(params)
        # the unfused weights go before the cache is allocated: a routed
        # model's gate and up stacks were copied into their pairs
        del params
        with GGUFReader(path) as r:
            md = r.metadata
        self.eos_id = (int(md.get("tokenizer.ggml.eos_token_id", 2))
                       if "tokenizer.ggml.tokens" in md else -1)
        self.max_batch = max_batch
        self.max_seq = max_seq or self.cfg.max_seq_len
        self.opts = opts
        self.cache = init_kv_cache(self.cfg, max_batch, self.max_seq,
                                   self.device)
        self.graphs = ChunkGraphs(self.device, max_batch,
                                  self.cfg.vocab_size, PREFILL_CHUNK)
        self.generator = self.graphs.generator   # every draw of generate
        self.tracer = Tracer()

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
        """One prompt chunk (1, t) into cache slot `slot` at
        start..start+t-1: on the card one CUDA graph replay per (t, span)
        key, on the CPU the same chunk on the same static buffers. Returns
        the logits row of chunk token `last_idx` (a static buffer, valid
        until the next chunk)."""
        def step(tokens, pos, rows):
            return forward(self.params, self.cfg, tokens, pos, self.cache,
                           self.opts, span=span, rows=rows)[0]

        return self.graphs.prefill(self.tracer, (toks.shape[-1], span,
                                                 self.opts),
                                   step, toks, slot, start, last_idx)

    def _prefill_eager(self, toks: np.ndarray, slot: int, start: int,
                       last_idx: int, span) -> torch.Tensor:
        """`_prefill` as eager launches over views of the slot's cache
        rows, each input a pageable copy: what the graphs are held to."""
        cache_1 = [{name: c[slot:slot + 1] for name, c in layer.items()}
                   for layer in self.cache]      # views: writes land in place
        # two copies from pageable host memory: each waits on the card
        tokens = torch.as_tensor(toks, device=self.device)
        pos = torch.tensor([start], dtype=torch.int32, device=self.device)
        llama.host_syncs += 2
        logits, _ = forward(self.params, self.cfg, tokens, pos, cache_1,
                            self.opts, span=span)
        return logits[0, last_idx]

    def _prefill_chunks(self, ids, slot: int, start: int = 0,
                        widths: dict | None = None,
                        stats: dict | None = None) -> torch.Tensor:
        """Prefill `ids` at start.. in PREFILL_CHUNK pieces with power-of-two
        tail buckets, halved until the padded call fits the cache;
        `widths`, where given, counts the chunks by padded width, and
        `stats` what their routed FFN ran (`prefill_moe_routed`,
        `prefill_expert_rows`). Returns the last prompt token's logits row
        (the caller's own copy)."""
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
            with self.tracer.span("prefill_chunk", t=tp):
                logits = self._prefill(toks, slot, start + off, take - 1,
                                       span)
            if widths is not None:
                widths[tp] = widths.get(tp, 0) + 1
            if stats is not None:
                layers, rows = self.graphs.last_prefill_moe
                stats["prefill_moe_routed"] += (
                    self.cfg.n_experts_used * layers * take)
                stats["prefill_expert_rows"] += rows
            off += take
            if off >= n:
                return logits.clone()

    def _decode(self, tokens, pos, sampler: SamplerConfig, steps: int, span,
                generator, logprobs: int = 0) -> Chunk:
        """`steps` decode iterations from token ids `tokens` (B,) at `pos`
        (B,): on the card one CUDA graph replay per chunk (captured at the
        key's first use), on the CPU the same chunk run eagerly on the same
        static buffers. Returns the chunk's outputs on the host: (B, steps)
        token ids and, with `logprobs` = k, the chosen logprobs and the
        top k. A stochastic sampler draws from `self.generator`, which
        `generator` must be."""
        return self.graphs.run(self, tokens, pos, sampler, steps, span,
                               generator, logprobs)

    def _decode_eager(self, tokens: torch.Tensor, pos: torch.Tensor,
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
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 stop_at_eos: bool = True, decode_chunk: int = DECODE_CHUNK,
                 on_tokens=None, logprobs: int = 0, stop_ids=None) -> list:
        """Generate completions for token-id prompts with continuous
        batching over the slot pool; one GenerationResult per prompt.

        The reference's arguments (`gguf_tpu/engine/engine.py:generate`):
        `decode_chunk` decode steps per host round trip (powers of two up
        to it; each (steps, span) pair is a CUDA graph on the card);
        `stop_at_eos`; `stop_ids`, extra terminator ids (stop reason
        "stop", trimmed like EOS); `on_tokens(request_index, new_ids,
        finished)`, called after each prefill and decode chunk with the
        request's new ids; `logprobs` = k > 0 records per generated token
        the chosen token's logprob and the top k in `.logprobs`. `seed`
        seeds `self.generator`, which every draw uses. With `self.tracer`
        on, the call's spans sit under one `generate` span."""
        with self.tracer.span("generate"):
            return self._generate(prompts, max_new_tokens, sampler, seed,
                                  stop_at_eos, decode_chunk, on_tokens,
                                  logprobs, stop_ids)

    def _generate(self, prompts, max_new_tokens, sampler, seed, stop_at_eos,
                  decode_chunk, on_tokens, logprobs, stop_ids) -> list:
        t_start = time.perf_counter_ns()
        tr = self.tracer
        gen = self.generator
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
        results = {i: GenerationResult(prompt_ids=ids,
                                       logprobs=[] if logprobs else None)
                   for i, ids in reversed(queue)}
        emitted = {i: 0 for i in results}
        done_emitted: set = set()

        def flush():
            if on_tokens is None:
                return
            with tr.span("flush"):
                for rid, res in results.items():
                    n = len(res.token_ids)
                    if n > emitted[rid] or (res.finished
                                            and rid not in done_emitted):
                        on_tokens(rid, res.token_ids[emitted[rid]:n],
                                  res.finished)
                        emitted[rid] = n
                        if res.finished:
                            done_emitted.add(rid)

        slots: list = [None] * self.max_batch     # request id per slot
        pos = np.zeros(self.max_batch, np.int64)
        last_tok = np.zeros(self.max_batch, np.int64)
        budget = np.zeros(self.max_batch, np.int64)
        eos = self.eos_id
        stop_set = frozenset(int(t) for t in (stop_ids or ()))
        prefill_ns = decode_ns = 0
        timing = {"decode_tokens": 0, "decode_finite": True,
                  "prefill_tokens": 0, "prefill_widths": {},
                  "prefill_syncs": 0, "prefill_moe_routed": 0,
                  "prefill_expert_rows": 0}
        capture_s = self.graphs.capture_s
        replays = self.graphs.prefill_replays

        def maybe_finish(s, tok):
            rid = slots[s]
            if rid is None:
                return
            hit_eos = stop_at_eos and tok == eos
            if not (hit_eos or tok in stop_set or budget[s] <= 0
                    or pos[s] + 1 >= self.max_seq):
                return
            res = results[rid]
            res.finished = True
            res.stop_reason = ("eos" if hit_eos else
                               "stop" if tok in stop_set else "length")
            if hit_eos or tok in stop_set:
                res.token_ids.pop()       # the terminator is not returned
                if res.logprobs:
                    res.logprobs.pop()
            slots[s] = None

        def admit():
            nonlocal prefill_ns
            free = [s for s in range(self.max_batch) if slots[s] is None]
            if not free or not queue:
                return
            with tr.span("admit"):
                for s in free[:len(queue)]:
                    rid, ids = queue.pop()
                    t0 = time.perf_counter_ns()
                    syncs = llama.host_syncs
                    with tr.span("prefill", t0) as sp:
                        logits = self._prefill_chunks(
                            ids, s, widths=timing["prefill_widths"],
                            stats=timing)
                        first_t = sample(logits[None, :], sampler, gen)
                        first = int(first_t[0])
                        llama.host_syncs += 1
                        if logprobs:
                            lp, tid, tlp = (x[0].tolist() for x in
                                            chosen_logprobs(logits[None, :],
                                                            first_t,
                                                            logprobs))
                            llama.host_syncs += 3
                            results[rid].logprobs.append(
                                {"logprob": lp, "top": list(zip(tid, tlp))})
                        t1 = time.perf_counter_ns()
                        sp.end(t1)
                    prefill_ns += t1 - t0
                    timing["prefill_tokens"] += len(ids)
                    timing["prefill_syncs"] += llama.host_syncs - syncs
                    slots[s] = rid
                    pos[s] = len(ids)
                    last_tok[s] = first
                    budget[s] = max_new_tokens - 1
                    results[rid].token_ids.append(first)
                    maybe_finish(s, first)

        admit()
        flush()
        while any(s is not None for s in slots) or queue:
            live = [s for s in range(self.max_batch) if slots[s] is not None]
            if not live:
                admit()
                flush()
                continue
            room = min(min(int(budget[s]) + 1, self.max_seq - int(pos[s]) - 1)
                       for s in live)
            steps = 1
            while steps * 2 <= min(decode_chunk, max(room, 1)):
                steps *= 2
            # inactive slots step at pos = max_seq: their cache inserts are
            # no-ops and their (discarded) outputs are garbage
            active = np.array([s is not None for s in slots])
            pos_dev = np.where(active, pos, self.max_seq)
            span = self._span_bucket(max(int(pos[s]) for s in live) + steps)
            t0 = time.perf_counter_ns()
            with tr.span("decode_chunk", t0) as sp:
                chunk = self._decode(last_tok, pos_dev, sampler, steps, span,
                                     gen, logprobs)
                t1 = time.perf_counter_ns()
                sp.end(t1)
            decode_ns += t1 - t0
            timing["decode_finite"] &= chunk.finite
            with tr.span("emit"):
                for j in range(steps):
                    for s in range(self.max_batch):
                        if slots[s] is None:
                            continue
                        tok = int(chunk.ids[s, j])
                        res = results[slots[s]]
                        if logprobs:
                            res.logprobs.append({
                                "logprob": float(chunk.logprob[s, j]),
                                "top": [(int(t), float(v)) for t, v in
                                        zip(chunk.top_ids[s, j],
                                            chunk.top_logprobs[s, j])]})
                        res.token_ids.append(tok)
                        timing["decode_tokens"] += 1
                        pos[s] += 1
                        last_tok[s] = tok
                        budget[s] -= 1
                        maybe_finish(s, tok)
            admit()
            flush()

        out = [results[i] for i in sorted(results)]
        flush()
        stats = {"wall_s": (time.perf_counter_ns() - t_start) / 1e9,
                 "new_tokens": sum(len(r.token_ids) for r in out),
                 "capture_s": self.graphs.capture_s - capture_s,
                 "prefill_replays": self.graphs.prefill_replays - replays,
                 "prefill_s": prefill_ns / 1e9, "decode_s": decode_ns / 1e9,
                 **timing}
        for r in out:
            r.stats = stats
        return out
