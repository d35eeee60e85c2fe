"""One benchmark run of a cell with the program's own tracer on (or off):
the harness's `run_cell` as it stands, with `LLM.tracer.enabled` set from
the constructor on and the tracer drained after each call, then the
program's spans reduced (`perfbench/program_spans.py`). The harness does
not turn the tracer on itself yet (PERF.md §7); this is the look at
what its spans show until it does. It wraps three of the harness's
functions for that, and is deleted by the `benchmark` change that makes
`harness.run_cell` turn the tracer on and read the spans itself.

    python3 -m perfbench.checks.engine_spans --workload <cell> --seed <n> \
        --seconds <s> [--trace 0|1] [--tracer 0|1] [--toy]

Prints one JSON line: the per-call `prefill_s` and `decode_s` of the
window (for the tracer's cost, on against off), the warm-up's captures
([steps, span, seconds] each), the queue wait's 90th percentile and the
mean decode turnaround over the window's calls, the result line's metrics
and, with `--trace 1`, the traced call's idle seconds by innermost
program span (`idle_by_span`), the share of the idle time inside
`generate` that falls in a span below it, its longest idle gaps named by
program span, and the MMQ roofline at prefill widths over the program's
prefill spans. `--toy` runs the cell at `checks.rehearse`'s toy size on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from perfbench import harness, roofline
from perfbench import program_spans as P
from perfbench import trace as tracing
from perfbench.metrics.common import quantile


def traced_run(cell, seed: int, seconds: float, trace: bool, on: bool,
               device: str) -> dict:
    """`harness.run_cell` with the tracer on (or off) throughout; returns
    its result, each call's (record, spans) in order (the warm-up, the
    window, the traced call), the Trace and its clock offset."""
    import gguf_tpu_torch.engine as engine

    calls, state = [], {}
    real_llm, real_serve, real_read = engine.LLM, harness.serve, tracing.read

    class LLM(real_llm):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tracer.enabled = on

    def serve(llm, cell, prompts, rec, gct):
        out = real_serve(llm, cell, prompts, rec, gct)
        calls.append((rec, llm.tracer.drain()))
        return out

    def read(prof, window, spans, markers):
        tr = real_read(prof, window, spans, markers)
        state["trace"], state["offset"] = tr, tr.window[0] - window[0]
        return tr

    engine.LLM, harness.serve, tracing.read = LLM, serve, read
    try:
        result = harness.run_cell(cell, seed, seconds, trace,
                                  time.perf_counter(), device=device,
                                  log=lambda s: print(s, file=sys.stderr,
                                                      flush=True))
    finally:
        engine.LLM, harness.serve, tracing.read = (real_llm, real_serve,
                                                   real_read)
    return {"result": result, "calls": calls, **state}


def summary(cell, run: dict, on: bool) -> dict:
    calls = run["calls"]
    traced = "trace" in run
    window = calls[1:-1] if traced else calls[1:]
    out = {"workload": cell.name, "tracer": on,
           "device": run["result"]["device"],
           "correct": run["result"]["correct"],
           "window_prefill_s": [c.stats["prefill_s"] for c, _ in window],
           "window_decode_s": [c.stats["decode_s"] for c, _ in window],
           "metrics": {k: v["value"]
                       for k, v in run["result"]["metrics"].items()}}
    if not on:
        return out
    spans = [s for _, sp in window for s in sp]
    turn = [t for _, sp in window for t in P.decode_turnarounds_ms(sp)]
    out.update({
        "spans_per_call": [len(sp) for _, sp in window],
        "setup_captures": P.captures(calls[0][1]),
        "queue_wait_p90_ms": quantile(
            [w for _, sp in window for w in P.queue_waits_ms(sp)], 0.90),
        "decode_turnaround_ms": float(np.mean(turn)) if turn else None})
    if traced:
        out.update(traced_call(cell, calls[-1][1], run["trace"],
                               run["offset"]))
    return out


def traced_call(cell, spans, trace, offset: int) -> dict:
    """The traced call's idle time and gaps by innermost program span,
    and the MMQ roofline at prefill widths over its prefill spans."""
    phases = P.Phases(spans, offset)
    gs, ge = P.idle_gaps(trace)
    idle = phases.idle_by_span(gs, ge, trace.window)
    root = P.by_name(spans, P.ROOT)[0]
    inside = phases.idle_by_span(gs, ge, (root.start_ns + offset,
                                          root.end_ns + offset))
    below = sum(v for k, v in inside.items() if k != P.ROOT)
    longest = np.argsort(gs - ge)[:10]
    names = phases.innermost((gs[longest] + ge[longest]) / 2.0)
    starts = trace.kernels[2]
    mask = np.zeros(len(starts), bool)
    for s in P.by_name(spans, "prefill"):
        mask |= (starts >= s.start_ns + offset) & (starts < s.end_ns + offset)
    seconds = trace.group_seconds(tracing.MMQ_GROUPS, mask)
    bound = sum(roofline.mmq_bound_s(cell.model, s.attrs["t"])
                for s in P.by_name(spans, "prefill_chunk"))
    return {"idle_by_span": idle,
            "idle_in_generate_s": sum(inside.values()),
            "idle_in_generate_below_root": (below / sum(inside.values())
                                            if inside else None),
            "idle_gaps": [[phases.name(int(i)), float(ge[j] - gs[j]) / 1e9]
                          for i, j in zip(names, longest)],
            "prefill_mmq_roofline": (100.0 * bound / seconds
                                     if seconds else None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--toy", action="store_true")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = "cuda"
    if args.toy:
        from perfbench.checks.rehearse import toy

        cell, device = toy(cell), "cpu"
    run = traced_run(cell, args.seed, args.seconds, bool(args.trace),
                     bool(args.tracer), device)
    print(json.dumps({"seed": args.seed,
                      **summary(cell, run, bool(args.tracer))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
