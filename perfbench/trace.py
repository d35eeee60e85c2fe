"""The traced run's instruments, all in the harness's own files: host
spans around the LLM instance's `_prefill_chunks` and `_decode` (with the
arguments the per-layer metrics need), `torch.profiler` over one call
after the window, recording the device's activity only, and the
reduction of its device events.

The spans wrap the instance's bound methods, so the program is not
changed. They take their times from the host clock, as the call's window
does: the profiler records no host operation (recording them made the
eager prefill 2.3-2.5x slower), so the host and device timelines are
aligned by a marker kernel launched after a device sync just before the
call, and checked by a second one just after it. The profiler still
slows the eager prefill (1.5-1.6x at 7B, CUPTI's cost per launch), so
host-clock numbers come from the untraced window.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# kernel-name pieces by which device time is grouped, as chip_smoke.py
# groups it (a kernel's template instances and tiles together;
# add_splits is every split-K kernel's sum, to_bf16 an operand cast)
KERNEL_GROUPS = ("mmq_q2_k", "mmq_q3_k", "mmq_q4_k", "mmq_q5_k", "mmq_q6_k",
                 "mmq_iq4", "mmq_q8_0", "mmq_q4_0", "mmq_q4_1", "mmq_q5_0",
                 "mmq_q5_1", "mmq_i8", "quantize_q8_1", "add_splits",
                 "to_bf16", "kv_insert", "attn_kernel", "tiled_")
MMQ_GROUPS = tuple(g for g in KERNEL_GROUPS if g.startswith("mmq_")) + (
    "add_splits", "to_bf16")
ATTN_GROUPS = ("attn_kernel", "tiled_")
SPAN_KINDS = ("prefill", "decode")
# the marker: torch.cuda._sleep's kernel, which the program never launches
MARKER = "spin_kernel"
_GENERIC = {"elementwise_kernel", "vectorized_elementwise_kernel",
            "unrolled_elementwise_kernel", "gpu_kernel_impl",
            "gpu_kernel_impl_nocast", "BinaryFunctor", "AUnaryFunctor",
            "BUnaryFunctor", "reduce_kernel", "ReduceOp", "func_wrapper_t"}


def short_name(name: str) -> str:
    """A kernel's name, shortened: torch's templated kernels as their
    outer kernel and the functor or op they run
    ("elementwise_kernel:direct_copy_kernel_cuda")."""
    if "at::native::" not in name:
        return name if len(name) <= 96 else name[:96]
    parts = re.findall(r"at::native::(?:\w+::)*(\w+)", name)
    outer = parts[0] if parts else name.split("<")[0].split()[-1]
    inner = next((p for p in parts[1:] if p not in _GENERIC), "")
    return f"{outer}:{inner}" if inner else outer


@dataclass
class Spans:
    """What the wrapped calls of the run saw: each decode chunk's steps
    and live positions, each prompt's length, with the index of the
    `generate` call they belong to; while `timing`, each wrapped call's
    start and end on the host clock (ns)."""
    call: int = -1                 # index of the call being run (0 = warm-up)
    decode: list = field(default_factory=list)   # (call, steps, live pos)
    prefill: list = field(default_factory=list)  # (call, prompt length)
    timing: bool = False
    times: dict = field(default_factory=lambda: {k: [] for k in SPAN_KINDS})

    def install(self, llm) -> None:
        prefill_chunks, decode = llm._prefill_chunks, llm._decode

        def traced_prefill(ids, *args, **kwargs):
            self.prefill.append((self.call, len(ids)))
            return self._timed("prefill", prefill_chunks, ids, *args,
                               **kwargs)

        def traced_decode(tokens, pos, sampler, steps, *args, **kwargs):
            live = np.asarray(pos, np.int64)
            self.decode.append((self.call, int(steps),
                                live[live < llm.max_seq].copy()))
            return self._timed("decode", decode, tokens, pos, sampler, steps,
                               *args, **kwargs)

        llm._prefill_chunks, llm._decode = traced_prefill, traced_decode

    def _timed(self, kind, fn, *args, **kwargs):
        if not self.timing:
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            self.times[kind].append((t0, time.perf_counter_ns()))

    def kv_rows_peak(self, first: int = 1, last: int | None = None) -> int:
        """The most cached rows live at once over calls first..last: at
        the end of each decode chunk, every live slot's position."""
        return max((int((live + steps).sum())
                    for call, steps, live in self.decode
                    if call >= first and (last is None or call <= last)),
                   default=0)


def marker(device, warm: int = 1) -> int:
    """Launch the marker kernel `warm` times, each followed by a device
    sync, then once more, and return the host clock (ns) just before that
    last launch; None where there is no card. The first launches after
    the profiler's `start` take its set-up: on a fresh machine one was
    delayed by 6 ms, and one trace held two of its four marks."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    for _ in range(warm):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return t


@dataclass
class Trace:
    """The device events of the traced call on the profiler's clock (ns),
    with the call's window and the host spans mapped onto it."""
    window: tuple                 # (start, end) of the traced call
    kernels: tuple                # (names, name index, starts, ends)
    spans: dict                   # kind -> (starts, ends) arrays, sorted
    drift_ns: int = 0             # end marker's offset less the start one's
    first_kernel_ns: int = 0      # window start to its first kernel
    seconds_to_read: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def union(self):
        """The device-busy intervals (merged) inside the window."""
        _, _, s, e = self.kernels
        lo, hi = self.window
        s, e = np.clip(s, lo, hi), np.clip(e, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        if not len(s):
            return s, e
        run_end = np.maximum.accumulate(e)
        new = np.empty(len(s), bool)
        new[0] = True
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, idx)
        return starts, ends

    def busy_s(self) -> float:
        s, e = self.union()
        return float((e - s).sum()) / 1e9

    def inside(self, kind: str) -> np.ndarray:
        """Mask of the kernels that start inside a span of `kind`."""
        _, _, s, _ = self.kernels
        ss, se = self.spans[kind]
        i = np.searchsorted(ss, s, side="right") - 1
        ok = i >= 0
        ok[ok] = s[ok] < se[i[ok]]
        return ok

    def group_seconds(self, groups, mask=None) -> float:
        names, idx, s, e = self.kernels
        hit = np.array([any(g in n for g in groups) for n in names], bool)[idx]
        if mask is not None:
            hit &= mask
        return float((e[hit] - s[hit]).sum()) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by KERNEL_GROUPS,
        else by name) and the longest idle gaps, each named by the span
        it fell in."""
        names, idx, s, e = self.kernels
        per_name = np.bincount(idx, weights=(e - s) / 1e9,
                               minlength=len(names))
        by = {}
        for n, d in zip(names, per_name):
            key = next((g for g in KERNEL_GROUPS if g in n), short_name(n))
            by[key] = by.get(key, 0.0) + float(d)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        bs, be = self.union()
        lo, hi = self.window
        gs = np.concatenate([[lo], be])
        ge = np.concatenate([bs, [hi]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        order = np.argsort(gs - ge)[:top]
        gaps = []
        for i in order:
            mid = (gs[i] + ge[i]) / 2
            kind = "host"
            for k in SPAN_KINDS:
                ss, se = self.spans[k]
                j = np.searchsorted(ss, mid, side="right") - 1
                if j >= 0 and mid < se[j]:
                    kind = k
            gaps.append([kind, float(ge[i] - gs[i]) / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def profiler(device):
    """The device's activity only on the card (kernels, copies, and the
    runtime calls CUPTI reports with them); host operations on the CPU,
    where there is no device to trace."""
    on_card = torch.device(device).type == "cuda"
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CUDA if on_card
                                              else act.CPU])


def read(prof, window: tuple, spans: Spans, markers: tuple) -> Trace:
    """Reduce the stopped profiler's raw events (without building the
    profiler's per-op tree, which is slow at a million kernels). `window`
    is the traced call on the host clock (ns) and `markers` the host
    times of the two marker launches around it (None on the CPU, where
    no clock is mapped and no kernel is traced)."""
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    index, ids, starts, ends, marks = {}, [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        name, st = ev.name(), ev.start_ns()
        if MARKER in name:
            marks.append(st)
            continue
        ids.append(index.setdefault(name, len(index)))
        starts.append(st)
        ends.append(st + ev.duration_ns())
    offset = drift = 0
    if markers[0] is not None:
        # the clocks' offset from the marker after the call, which the
        # profiler, running by then, always records; the one before the
        # call (the nearest mark) only checks it
        if not marks:
            raise RuntimeError("the trace holds no marker kernel")
        marks.sort()
        offset = marks[-1] - markers[1]
        start = min(marks[:-1] or marks,
                    key=lambda t: abs(t - offset - markers[0]))
        drift = offset - (start - markers[0])
    arr = {}
    for k in SPAN_KINDS:
        a = np.array(sorted(spans.times[k]), np.int64).reshape(-1, 2) + offset
        arr[k] = (a[:, 0], a[:, 1])
    lo = window[0] + offset
    starts = np.array(starts, np.int64)
    inside = starts[starts >= lo]
    tr = Trace((lo, window[1] + offset),
               (list(index), np.array(ids, np.int64), starts,
                np.array(ends, np.int64)),
               arr, drift_ns=int(drift),
               first_kernel_ns=int(inside.min() - lo) if len(inside) else 0)
    tr.seconds_to_read = time.perf_counter() - t0
    return tr
