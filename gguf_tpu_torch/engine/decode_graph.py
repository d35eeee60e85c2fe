"""The decode chunk as CUDA graphs: the counterpart of the reference's
compiled `_decode` (`gguf_tpu/engine/engine.py`), one `jax.jit` around a
`lax.scan` of `steps` iterations (forward, sample, pos + 1) that runs a
whole chunk as one dispatch and one device-to-host copy.

Eager PyTorch issues each step's kernels from the host (about 2,000 per
step on Llama-2-7B). `DecodeGraphs` captures the same chunk once per key
(steps, span, sampler, logprobs k, MMOpts) into a CUDA graph at the key's
first use and replays it afterwards. A call copies the token ids and
positions into static input buffers, replays, and reads every output (the
ids, with `k` also the chosen logprobs and the top-k, and a flag that
every logit was finite) in one device-to-host copy. The KV cache is
updated in place, as the eager loop updates it. All graphs share one
memory pool, since they never run at once; the chunk's outputs are copied
into buffers allocated outside it, so no graph's live data sits in the
pool. Each stochastic graph registers the engine's generator, so every
replay draws new numbers and `manual_seed` at the start of `generate`
decides them.

Before a capture the chunk runs once eagerly on a side stream (as torch
requires), drawing from a scratch generator so that the engine's draws do
not depend on which keys were captured before. That run writes the same
cache rows the replay right after it rewrites. The wrappers' launch
counters advance in that run and in the capture, never in a replay.

On the CPU nothing is captured: the same object runs the same chunk on
the same static buffers, so the buffer logic (copy in, the cache updated
in place, copy out) runs in the CPU tests. On cuda a failed capture or
replay raises; nothing falls back to the eager loop.

With the LLM's tracer on, a call records `copy_in`, `capture` (with its
key's steps and span), `replay` (on the CPU: the eager run of the chunk)
and `read` spans, all outside the captured code.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import llama
from ..models.llama import forward
from .sampler import SamplerConfig, logprobs, sample


class Chunk(NamedTuple):
    """One decode chunk's outputs on the host."""
    ids: np.ndarray                     # (B, steps) int32 token ids
    logprob: np.ndarray | None          # (B, steps) chosen tokens' logprobs
    top_ids: np.ndarray | None          # (B, steps, k) int32
    top_logprobs: np.ndarray | None     # (B, steps, k), largest first
    finite: bool                        # every logit of the chunk finite


class _Bucket:
    """A key's static output buffer, its views, and its graph (None on the
    CPU). Every output is 4 bytes wide, so one int32 buffer holds them all
    and one copy reads them: ids (B, steps), the finite flag, and with k
    the chosen logprobs (B, steps), top ids and top logprobs (B, steps,
    k), the float ones as f32 views."""

    def __init__(self, batch: int, steps: int, k: int, device):
        n = batch * steps
        self.shape, self.k, self.graph = (batch, steps), k, None
        self.out = torch.zeros(2 * n + 1 + 2 * n * k, dtype=torch.int32,
                               device=device)
        self.ids = self.out[:n].view(batch, steps)
        self.finite = self.out[n]
        self.logprob = self.out[n + 1:2 * n + 1].view(torch.float32) \
            .view(batch, steps)
        self.top_ids = self.out[2 * n + 1:2 * n + 1 + n * k] \
            .view(batch, steps, k)
        self.top_logprobs = self.out[2 * n + 1 + n * k:] \
            .view(torch.float32).view(batch, steps, k)

    def read(self) -> Chunk:
        """Every output in one device-to-host copy (a host-device sync)."""
        host = self.out.cpu().numpy()
        llama.host_syncs += 1
        (b, steps), k, n = self.shape, self.k, self.shape[0] * self.shape[1]
        ids = host[:n].reshape(b, steps)
        if not k:
            return Chunk(ids, None, None, None, bool(host[n]))
        lp = host[n + 1:2 * n + 1].view(np.float32).reshape(b, steps)
        tid = host[2 * n + 1:2 * n + 1 + n * k].reshape(b, steps, k)
        tlp = host[2 * n + 1 + n * k:].view(np.float32).reshape(b, steps, k)
        return Chunk(ids, lp, tid, tlp, bool(host[n]))


class DecodeGraphs:
    """The decode chunks of one `LLM`: static inputs, a bucket per key, a
    CUDA graph per bucket on cuda. It holds no reference to the LLM (the
    caller passes it), so the LLM's memory is freed with it."""

    def __init__(self, device, batch: int):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        # row 0 token ids, row 1 positions
        self.inputs = torch.zeros((2, batch), dtype=torch.int32,
                                  device=self.device)
        self.buckets: dict = {}
        self.capture_s = 0.0       # warm-up, capture and instantiation
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self._warm_gen = torch.Generator(device=self.device)
            self._staging = torch.zeros((2, batch),
                                        dtype=torch.int32).pin_memory()
            self._copied = torch.cuda.Event()

    def keys(self) -> list:
        """(steps, span, sampler, logprobs k, MMOpts) of every bucket."""
        return list(self.buckets)

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds for the graphs' shared pool
        (None where the snapshot does not name pools; 0 on the CPU)."""
        if not self.on_card:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))

    def run(self, llm, tokens, pos, sampler: SamplerConfig, steps: int,
            span, generator, k: int = 0) -> Chunk:
        """`steps` decode iterations of `llm` from token ids `tokens` (B,)
        at positions `pos` (B,) (tensors or arrays); the outputs on the
        host."""
        bucket = self.launch(llm, tokens, pos, sampler, steps, span,
                             generator, k)
        with llm.tracer.span("read"):
            return bucket.read()

    def launch(self, llm, tokens, pos, sampler: SamplerConfig, steps: int,
               span, generator, k: int = 0) -> _Bucket:
        """Copy the inputs in and replay the key's graph (capturing it at
        its first use), or on the CPU run the chunk; returns the bucket
        whose `read()` waits for the outputs."""
        stochastic = sampler.temperature > 0.0
        if stochastic and generator is not self.generator:
            raise ValueError("a stochastic decode chunk draws from the "
                             "engine's generator (LLM.generator)")
        tr = llm.tracer
        with tr.span("copy_in"):
            self._copy_in(tokens, pos)
        key = (steps, span, sampler, k, llm.opts)
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = _Bucket(self.inputs.shape[1], steps, k, self.device)
            if self.on_card:
                with tr.span("capture", steps=steps, span=span):
                    self._capture(bucket, llm, key, stochastic)
            self.buckets[key] = bucket
        with tr.span("replay"):
            if bucket.graph is not None:
                bucket.graph.replay()
            else:
                self._chunk(bucket, llm, key, generator)
        return bucket

    def _copy_in(self, tokens, pos) -> None:
        tok, p = torch.as_tensor(tokens), torch.as_tensor(pos)
        if self.on_card and tok.device.type == "cpu":
            # host arrays: one copy from pinned memory, once the last one
            # has left it (an event wait, not counted in llama.host_syncs:
            # the last chunk's read has already waited for that copy)
            self._copied.synchronize()
            self._staging[0].copy_(tok)
            self._staging[1].copy_(p)
            self.inputs.copy_(self._staging, non_blocking=True)
            self._copied.record()
        else:
            self.inputs[0].copy_(tok)
            self.inputs[1].copy_(p)

    def _chunk(self, bucket: _Bucket, llm, key: tuple, generator) -> None:
        """The reference's scan body `steps` times on the static inputs,
        then the outputs into the bucket: what a graph captures, and what
        the CPU runs."""
        steps, span, sampler, k, opts = key
        toks, pos = self.inputs[0], self.inputs[1]
        ids, extras, finite = [], [], None
        for _ in range(steps):
            logits, _ = forward(llm.params, llm.cfg, toks[:, None], pos,
                                llm.cache, opts, span=span)
            row = logits[:, 0]
            toks = sample(row, sampler, generator)
            ok = torch.isfinite(row).all()
            finite = ok if finite is None else finite & ok
            if k:
                extras.append(logprobs(row, toks, k))
            ids.append(toks)
            pos = pos + 1
        bucket.ids.copy_(torch.stack(ids, dim=1))
        bucket.finite.copy_(finite)
        if k:
            for dst, parts in zip((bucket.logprob, bucket.top_ids,
                                   bucket.top_logprobs), zip(*extras)):
                dst.copy_(torch.stack(parts, dim=1))

    def _capture(self, bucket: _Bucket, llm, key: tuple,
                 stochastic: bool) -> None:
        """Warm the chunk up on the side stream, then capture it there into
        the shared pool. Raises if the capture fails."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        if stochastic:
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream):
            self._chunk(bucket, llm, key, self._warm_gen)
            graph.capture_begin(pool=self.pool)
            try:
                self._chunk(bucket, llm, key, self.generator)
            finally:
                graph.capture_end()
        main.wait_stream(self.stream)
        bucket.graph = graph
        self.capture_s += time.perf_counter() - t0
