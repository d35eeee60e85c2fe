"""Reductions of the program's own spans (`LLM.tracer`,
`gguf_tpu_torch/engine/trace.py`): what the harness could read once it
turns the tracer on (PERF.md §7 says which harness edits that takes).
`perfbench/checks/engine_spans.py` reads them today.

Spans are the tracer's `Span` records (name, start_ns, end_ns, id,
parent, attrs) on the host clock. They nest, so at each instant one is
innermost. It is named by its parent and itself (`decode_chunk/replay`,
`prefill/prefill_chunk`), by itself where its parent is the root
(`emit`), and the root by `generate`.

`Phases` and `idle_gaps` repeat what `trace.Trace.breakdown` does for
the harness's own spans. They move into `perfbench/trace.py`, and this
module's copy of the gap computation goes, in the `benchmark` change
that makes `harness.run_cell` turn the tracer on (PERF.md §7).
"""

from __future__ import annotations

import numpy as np

ROOT = "generate"
OUTSIDE = "outside"            # no program span around the instant


def by_name(spans, name: str) -> list:
    return sorted((s for s in spans if s.name == name),
                  key=lambda s: s.start_ns)


def queue_waits_ms(spans) -> list:
    """Per request of one call: its admission (the start of its `prefill`
    span) less the call's start (its `generate` span's)."""
    root = by_name(spans, ROOT)[0]
    return [(s.start_ns - root.start_ns) / 1e6
            for s in by_name(spans, "prefill")]


def decode_turnarounds_ms(spans) -> list:
    """Per pair of consecutive decode chunks of one call: the end of the
    later one's `replay` (its graph launched) less the end of the earlier
    one's `read` (the device idle from there, its outputs on the host),
    less the admission sweeps between them (their prefills keep the
    device busy)."""
    ends = {}
    for s in spans:
        if s.name in ("replay", "read"):
            ends[(s.parent, s.name)] = s.end_ns
    admits = [(s.start_ns, s.end_ns) for s in by_name(spans, "admit")]
    chunks = by_name(spans, "decode_chunk")
    out = []
    for prev, cur in zip(chunks, chunks[1:]):
        t0, t1 = ends[(prev.id, "read")], ends[(cur.id, "replay")]
        busy = sum(e - s for s, e in admits if t0 <= s and e <= t1)
        out.append((t1 - t0 - busy) / 1e6)
    return out


def captures(spans) -> list:
    """[steps, span, seconds] of each graph capture."""
    return [[s.attrs["steps"], s.attrs["span"], (s.end_ns - s.start_ns) / 1e9]
            for s in by_name(spans, "capture")]


class Phases:
    """The phase spans of one call, shifted by `offset_ns` (onto the
    profiler's clock), and the innermost phase's name at any instant."""

    def __init__(self, spans, offset_ns: int = 0):
        by_id = {s.id: s for s in spans}

        def depth(s):
            d = 0
            while s.parent in by_id:
                s, d = by_id[s.parent], d + 1
            return d

        self.labels = []
        levels: dict = {}
        for s in spans:
            p = by_id.get(s.parent)
            label = (s.name if p is None or p.name == ROOT
                     else f"{p.name}/{s.name}")
            levels.setdefault(depth(s), []).append(
                (s.start_ns + offset_ns, s.end_ns + offset_ns,
                 len(self.labels)))
            self.labels.append(label)
        # spans of one depth are disjoint: sorted starts find the one
        # around an instant
        self.levels = []
        for d in sorted(levels):
            a = np.array(sorted(levels[d]), np.int64).reshape(-1, 3)
            self.levels.append((a[:, 0], a[:, 1], a[:, 2]))
        self.bounds = (np.unique(np.concatenate([x for s, e, _ in self.levels
                                                 for x in (s, e)]))
                       if self.levels else np.zeros(0, np.int64))

    def innermost(self, t) -> np.ndarray:
        """Index into `labels` of the innermost phase around each instant
        of `t` (-1: none)."""
        t = np.asarray(t, np.float64)
        out = np.full(t.shape, -1, np.int64)
        for starts, ends, idx in self.levels:
            j = np.searchsorted(starts, t, side="right") - 1
            ok = j >= 0
            ok[ok] = t[ok] < ends[j[ok]]
            out[ok] = idx[j[ok]]
        return out

    def name(self, i: int) -> str:
        return self.labels[i] if i >= 0 else OUTSIDE

    def idle_by_span(self, gap_starts, gap_ends, window) -> dict:
        """Idle seconds inside `window` by the innermost phase around
        them: the idle intervals (sorted, disjoint) cut at every phase
        boundary."""
        gs, ge = np.asarray(gap_starts, np.int64), np.asarray(gap_ends,
                                                              np.int64)
        cuts = np.unique(np.concatenate(
            [[window[0], window[1]],
             self.bounds[(self.bounds > window[0])
                         & (self.bounds < window[1])]]))
        idle = _idle_before(gs, ge, cuts)
        per = np.diff(idle)
        mids = (cuts[:-1] + cuts[1:]) / 2.0
        who = self.innermost(mids)
        out: dict = {}
        for i, v in zip(who, per):
            if v > 0:
                out[self.name(int(i))] = out.get(self.name(int(i)), 0.0) \
                    + float(v) / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _idle_before(gs, ge, t) -> np.ndarray:
    """Idle time (ns) in the intervals (gs, ge) before each instant of t."""
    if not len(gs):
        return np.zeros(len(t), np.float64)
    full = np.concatenate([[0], np.cumsum(ge - gs)])
    k = np.searchsorted(ge, t, side="right")       # intervals ended by t
    part = np.zeros(len(t), np.float64)
    inside = k < len(gs)
    kk = k[inside]
    part[inside] = np.clip(t[inside] - gs[kk], 0, None)
    return full[k] + part


def idle_gaps(trace) -> tuple:
    """The idle intervals of a harness `Trace` (`perfbench/trace.py`):
    its window less the union of its kernel intervals."""
    bs, be = trace.union()
    lo, hi = trace.window
    gs = np.concatenate([[lo], be]).astype(np.int64)
    ge = np.concatenate([bs, [hi]]).astype(np.int64)
    keep = ge > gs
    return gs[keep], ge[keep]
