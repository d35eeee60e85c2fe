"""The decode and prefill chunks as CUDA graphs: the counterpart of the
reference's compiled `_decode` (`gguf_tpu/engine/engine.py`), one
`jax.jit` around a `lax.scan` of `steps` iterations (forward, sample, pos
+ 1) that runs a whole chunk as one dispatch and one device-to-host copy,
and of its jitted prefill chunk.

Eager PyTorch issues each step's kernels from the host (about 2,000 per
step on Llama-2-7B). `ChunkGraphs` captures each chunk once per key into
a CUDA graph at the key's first use and replays it afterwards:

- a decode chunk per (steps, span, sampler, logprobs k, MMOpts). A call
  copies the token ids and positions into static input buffers, replays,
  and reads every output (the ids, with `k` also the chosen logprobs and
  the top-k, and a flag that every logit was finite) in one
  device-to-host copy. Each stochastic graph registers the engine's
  generator, so every replay draws new numbers and `manual_seed` at the
  start of `generate` decides them.
- a prefill chunk per (t, span, MMOpts), t its padded width. The slot,
  the start position, the index of the row whose logits are kept and the
  t token ids go into one static input buffer; the graph runs the
  engine's forward step, which addresses the slot's cache rows through it
  (`forward`'s `rows`), gathers that logits row into a static output and
  ANDs a flag that every logit was finite. Nothing is read back: the
  caller's first-token sample is the prompt's one sync.

Inputs from the host go through one pinned staging buffer per input
buffer and one copy that waits on an event, never a pageable copy. The KV
cache is updated in place, as the eager chunks update it. All graphs
share one memory pool, since they never run at once; the chunks' outputs
are copied into buffers allocated outside it, so no graph's live data
sits in the pool.

Before a capture the chunk runs once eagerly on a side stream (as torch
requires), a decode chunk drawing from a scratch generator so that the
engine's draws do not depend on which keys were captured before. That
run writes the same cache rows the replay right after it rewrites. The
wrappers' launch counters advance in that run and in the capture, never
in a replay.

On the CPU nothing is captured: the same object runs the same chunk on
the same static buffers, so the buffer logic (copy in, the cache updated
in place, copy out) runs in the CPU tests. On cuda a failed capture or
replay raises; nothing falls back to an eager chunk.

With the LLM's tracer on, a decode call records `copy_in`, `capture`
(with its key's steps and span), `replay` (on the CPU: the eager run of
the chunk) and `read` spans; a prefill chunk records only its `capture`
(with its key's t and span), inside the engine's `prefill_chunk` span.
All of them lie outside the captured code.
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


class ChunkGraphs:
    """The decode and prefill chunks of one `LLM`: static inputs, a bucket
    per decode key, a graph per key on cuda. It holds no reference to the
    LLM (the caller passes it), so the LLM's memory is freed with it."""

    def __init__(self, device, batch: int, vocab: int, width: int):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        # decode: row 0 token ids, row 1 positions
        self.inputs = torch.zeros((2, batch), dtype=torch.int32,
                                  device=self.device)
        # prefill: slot, start, the kept row's index, then up to `width`
        # token ids; the kept logits row; False once a prefill chunk's
        # logits were not all finite (the caller resets it)
        self.prefill_in = torch.zeros(3 + width, dtype=torch.int32,
                                      device=self.device)
        self.prefill_out = torch.zeros(vocab, dtype=torch.float32,
                                       device=self.device)
        self.prefill_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)
        self.buckets: dict = {}
        self.prefill_graphs: dict = {}
        self.capture_s = 0.0       # warm-up, capture and instantiation
        # prefill chunks whose key an earlier chunk captured (on the CPU:
        # ran), so that a capture inside a window shows
        self.prefill_replays = 0
        # per prefill key, what one chunk's routed FFN ran: (expert layers,
        # expert-product rows) from `llama.moe_layers_run` and
        # `llama.expert_rows` where the chunk last ran in Python (its
        # capture; on the CPU each run); and that of the last chunk
        self.prefill_moe: dict = {}
        self.last_prefill_moe = (0, 0)
        self.on_card = self.device.type == "cuda"
        # pinned staging buffers of `inputs` and `prefill_in` (on the card)
        self._inputs_host = self._prefill_host = None
        if self.on_card:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self._warm_gen = torch.Generator(device=self.device)
            self._inputs_host = torch.zeros_like(self.inputs,
                                                 device="cpu").pin_memory()
            self._prefill_host = torch.zeros_like(self.prefill_in,
                                                  device="cpu").pin_memory()
            self._copied = torch.cuda.Event()

    def keys(self) -> list:
        """(steps, span, sampler, logprobs k, MMOpts) of every decode
        bucket."""
        return list(self.buckets)

    def prefill_keys(self) -> list:
        """(t, span, MMOpts) of every prefill chunk run so far."""
        return list(self.prefill_graphs)

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
            self._copy_in(self.inputs, self._inputs_host, (tokens, pos))
        key = (steps, span, sampler, k, llm.opts)
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = _Bucket(self.inputs.shape[1], steps, k, self.device)
            if self.on_card:
                with tr.span("capture", steps=steps, span=span):
                    bucket.graph = self._capture(
                        lambda gen: self._chunk(bucket, llm, key, gen),
                        stochastic)
            self.buckets[key] = bucket
        with tr.span("replay"):
            if bucket.graph is not None:
                bucket.graph.replay()
            else:
                self._chunk(bucket, llm, key, generator)
        return bucket

    def prefill(self, tracer, key: tuple, step, toks: np.ndarray,
                slot: int, start: int, last_idx: int) -> torch.Tensor:
        """One prefill chunk: the (1, t) token ids `toks` into cache slot
        `slot` at start..start+t-1, by the replay of the key's graph
        (captured at its first use), or on the CPU the chunk run on the
        same buffers. `key` is (t, span, MMOpts); `step(tokens (1, t),
        pos (1,), rows (1,))` is the model's forward over the slot's cache
        rows, returning the logits (1, t, vocab). Returns the static
        logits row of chunk token `last_idx`, valid until the next chunk;
        reads nothing back."""
        t, span = key[:2]
        if t > self.prefill_in.numel() - 3:
            raise ValueError(f"a {t}-token prefill chunk exceeds the static "
                             f"buffer's {self.prefill_in.numel() - 3}")
        self._copy_in(self.prefill_in, self._prefill_host,
                      (np.array([slot, start, last_idx]), toks))
        if key in self.prefill_graphs:
            self.prefill_replays += 1
        else:
            graph = None
            if self.on_card:
                with tracer.span("capture", t=t, span=span):
                    graph = self._capture(
                        lambda gen: self._prefill_chunk(step, key))
            self.prefill_graphs[key] = graph
        graph = self.prefill_graphs[key]
        if graph is not None:
            graph.replay()
        else:
            self._prefill_chunk(step, key)
        self.last_prefill_moe = self.prefill_moe[key]
        return self.prefill_out

    def _copy_in(self, dst: torch.Tensor, staging, parts) -> None:
        """Fill the leading elements of the static input `dst` with
        `parts` in order (arrays or tensors). From host memory on the
        card: into `dst`'s pinned staging buffer `staging` once the last
        copy has left it (an event wait, not counted in llama.host_syncs:
        the chunk's read, or the prompt's first-token read, has already
        waited for that copy), then one asynchronous copy."""
        parts = [torch.as_tensor(p).reshape(-1) for p in parts]
        host = staging is not None and all(p.device.type == "cpu"
                                           for p in parts)
        if host:
            self._copied.synchronize()
        buf = (staging if host else dst).view(-1)
        n = 0
        for p in parts:
            buf[n:n + p.numel()].copy_(p)
            n += p.numel()
        if host:
            dst.view(-1)[:n].copy_(buf[:n], non_blocking=True)
            self._copied.record()

    def _chunk(self, bucket: _Bucket, llm, key: tuple, generator) -> None:
        """The reference's scan body `steps` times on the static inputs,
        then the outputs into the bucket: what a decode graph captures,
        and what the CPU runs."""
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

    def _prefill_chunk(self, step, key: tuple) -> None:
        """`step` on the static prefill input of key (t, span, MMOpts), its
        kept logits row gathered into the static output and its logits'
        finiteness ANDed into `prefill_finite`: what a prefill graph
        captures, and what the CPU runs. Records what the routed FFN ran
        in `prefill_moe[key]`."""
        t = key[0]
        ran = llama.moe_layers_run, llama.expert_rows
        inp = self.prefill_in
        logits = step(inp[3:3 + t].view(1, t), inp[1:2], inp[0:1])
        self.prefill_out.copy_(logits[0].index_select(0, inp[2:3])[0])
        self.prefill_finite.logical_and_(torch.isfinite(logits).all())
        self.prefill_moe[key] = (llama.moe_layers_run - ran[0],
                                 llama.expert_rows - ran[1])

    def _capture(self, body, stochastic: bool = False):
        """Warm `body(generator)` up on the side stream, then capture it
        there into the shared pool; returns the graph. Raises if the
        capture fails."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        if stochastic:
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream):
            body(self._warm_gen)
            graph.capture_begin(pool=self.pool)
            try:
                body(self.generator)
            finally:
                graph.capture_end()
        main.wait_stream(self.stream)
        self.capture_s += time.perf_counter() - t0
        return graph
