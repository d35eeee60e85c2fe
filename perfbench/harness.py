"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything a cell needs is found by name: `BENCHMARK.json` names the
cell's configuration (`perfbench/configs/<file>`, whose `architecture`
names `perfbench/archs/<name>.py` and `reference`
`perfbench/references/<name>.py`) and traffic
(`perfbench/traffic/<name>.json`), the metrics it reports (each read by
`perfbench/metrics/<name>.py`), and the correctness limits and the
size of the reference's sample sit in `perfbench/limits/<cell>.json`. The harness holds no per-cell code.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from . import roofline
from . import trace as tracing
from .model import HERE, Model, nbytes, tensor_plan
from .traffic import Traffic
from .traffic import load as load_traffic
from .weights import Checkpoint, make_bytes, views

ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# numbers of the served tokens' gaps below the reference's best logit
GAP_NUMBERS = {"max_gap": lambda g: float(g.max()),
               "mean_gap": lambda g: float(g.mean()),
               "not_argmax_share": lambda g: float((g > 0).mean())}


@dataclass
class Cell:
    name: str
    model: Model
    traffic: Traffic
    chips: int
    end_to_end: list
    per_layer: list
    reference: str
    limits: dict             # compared gap numbers and their limits
    check_requests: int      # requests the reference checks per run


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        reference = json.load(f)["reference"]
    limits_path = os.path.join(root, "perfbench", "limits", name + ".json")
    limits, check_requests = {}, 8
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            spec = json.load(f)
        limits, check_requests = spec["limits"], spec["check_requests"]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name,
                model=Model.from_file(conf["name"],
                                      os.path.join(root, conf["file"])),
                traffic=load_traffic(root, cell["traffic"]),
                chips=int(cell["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)],
                reference=reference, limits=limits,
                check_requests=check_requests)


def reader(name: str):
    """The module that reads metric `name` (see `perfbench.metrics`)."""
    for stem in (name, name.split(".", 1)[0]):
        if os.path.exists(os.path.join(HERE, "metrics", stem + ".py")):
            return importlib.import_module(f"perfbench.metrics.{stem}")
    raise SystemExit(f"no reader perfbench/metrics/{name}.py")


@dataclass
class Call:
    """One `generate` call of the window, on the host clock."""
    t0: float
    t1: float = 0.0
    prompt_lens: list = field(default_factory=list)
    served: list = field(default_factory=list)      # tokens per request
    first: list = field(default_factory=list)       # first delivery time
    deliveries: list = field(default_factory=list)  # [(time, tokens)]
    stats: dict = field(default_factory=dict)
    gc_s: float = 0.0            # Python's garbage collection inside it


@dataclass
class Run:
    model: Model
    traffic: Traffic
    setup_s: float
    calls: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    spans: tracing.Spans | None = None
    trace: tracing.Trace | None = None
    traced_call: int = 0         # the call after the window (trace runs)


def build_kernels() -> int:
    """Build every CUDA source of the port at once (nvcc in parallel) into
    its fixed build directory, where later runs find them by hash;
    returns how many were missing and built."""
    from gguf_tpu_torch.ops import build

    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    missing = sum(not os.path.exists(build.library_path(n)) for n in names)
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    return missing


class GCTimer:
    """Seconds Python's garbage collector has run since the start."""

    def __init__(self):
        self.total, self._t = 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None

    def close(self):
        gc.callbacks.remove(self._cb)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(llm, cell: Cell, prompts: list, rec: Call, gct: GCTimer) -> list:
    """One timed `generate` call of the cell's traffic; fills `rec`."""
    from gguf_tpu_torch.engine import SamplerConfig

    gc0 = gct.total

    n = len(prompts)
    rec.prompt_lens = [len(p) for p in prompts]
    rec.first = [None] * n
    rec.deliveries = [[] for _ in range(n)]

    def on_tokens(rid, ids, finished):
        t = time.perf_counter()
        if ids and rec.first[rid] is None:
            rec.first[rid] = t
        rec.deliveries[rid].append((t, len(ids)))

    out = llm.generate(prompts, max_new_tokens=cell.traffic.max_new_tokens,
                       sampler=SamplerConfig(), stop_at_eos=False,
                       on_tokens=on_tokens)
    rec.t1 = time.perf_counter()
    rec.gc_s = gct.total - gc0
    rec.served = [len(r.token_ids) for r in out]
    rec.stats = dict(out[0].stats)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", opts=None,
             log=print, control: bool = False) -> dict:
    """Set up, measure, check; returns the result line's object. With
    `control` (`perfbench/readings.py` and the tests only) the fp8
    control's gaps are read beside the program's and put through the same
    comparison (`control_correct`)."""
    from gguf_tpu_torch.engine import LLM
    from gguf_tpu_torch.models.llama import MMOpts

    m, tr = cell.model, cell.traffic
    on_card = torch.device(device).type == "cuda"
    gct = GCTimer()
    parts = {}
    t = time.perf_counter()
    built = build_kernels() if on_card else 0
    parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    buffers = make_bytes(m, seed, device)
    ckpt = Checkpoint(m, buffers, os.path.join(CACHE, "checkpoint"))
    del buffers
    if on_card:
        torch.cuda.empty_cache()    # the drawn bytes' blocks go back
    parts["checkpoint_s"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        llm = LLM(ckpt.path, device=device, max_batch=m.max_batch,
                  max_seq=m.max_seq, opts=opts or MMOpts())
    finally:
        ckpt.close()
    parts["load_s"] = time.perf_counter() - t
    # the spans record each chunk's shapes in every run (the filled cache
    # rows); only the traced call times them
    spans = tracing.Spans()
    spans.install(llm)

    # warm-up: call 0 has the window's shapes (the run's prompt-length
    # order), so it captures every decode graph the window replays
    t = time.perf_counter()
    spans.call = 0
    serve(llm, cell, tr.call(seed, 0, m.vocab), Call(time.perf_counter()),
          gct)
    sync(device)
    parts["warmup_s"] = time.perf_counter() - t
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run = Run(m, tr, setup_s=time.perf_counter() - t_start, spans=spans)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"set-up {run.setup_s:.3f} s ({built} kernel libraries built; "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + ")")

    requests = []
    w0 = time.perf_counter()
    index = 1
    while index == 1 or time.perf_counter() - w0 < seconds:
        spans.call = index
        prompts = tr.call(seed, index, m.vocab)
        rec = Call(time.perf_counter())
        out = serve(llm, cell, prompts, rec, gct)
        run.calls.append(rec)
        log_call(log, index, rec)
        requests += [(p, r.token_ids) for p, r in zip(prompts, out)]
        index += 1
    run.window = (w0, run.calls[-1].t1)
    log(f"window {run.window[1] - w0:.3f} s, {len(run.calls)} calls, "
        f"{len(requests)} requests")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kv_rows = spans.kv_rows_peak(1, index - 1)
    trace_cost = None
    if trace:
        # one more call of the same shapes, after the window, under the
        # profiler: the window's host-clock numbers stay untraced
        run.traced_call = spans.call = index
        prompts = tr.call(seed, index, m.vocab)
        prof = tracing.profiler(device)
        prof.start()
        spans.timing = True
        m0 = tracing.marker(device, warm=3)
        c0 = time.perf_counter_ns()
        rec = Call(time.perf_counter())
        out = serve(llm, cell, prompts, rec, gct)
        sync(device)
        c1 = time.perf_counter_ns()
        m1 = tracing.marker(device)
        sync(device)
        spans.timing = False
        prof.stop()
        log_call(log, index, rec, " (traced)")
        run.trace = tracing.read(prof, (c0, c1), spans, (m0, m1))
        trace_cost = {k: rec.stats[k] / np.mean([c.stats[k]
                                                 for c in run.calls])
                      for k in ("prefill_s", "decode_s")}
        trace_cost["call"] = (rec.t1 - rec.t0) / np.mean(
            [c.t1 - c.t0 for c in run.calls])
        log(f"trace read in {run.trace.seconds_to_read:.3f} s; clocks drift "
            f"{run.trace.drift_ns / 1e3:.1f} us over the call; first kernel "
            f"{run.trace.first_kernel_ns / 1e3:.1f} us into it; traced call "
            "over the window's mean: " + ", ".join(
                f"{k} {v:.3f}x" for k, v in trace_cost.items()))
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = reader(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    capture_in_window = sum(c.stats.get("capture_s", 0.0) for c in run.calls)
    gct.close()

    # the check: the program is freed first, so the reference's memory
    # never sets the peak
    expect = tr.max_new_tokens
    failed = sum(1 for c in run.calls for n in c.served if n != expect)
    nonfinite = sum(1 for c in run.calls if not c.stats["decode_finite"])
    del llm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pick = tr.sample(seed, requests, cell.check_requests)
    t_ref = time.perf_counter()
    weights = views(m, make_bytes(m, seed, device))
    ref = importlib.import_module(f"perfbench.references.{cell.reference}")
    sample = [requests[i] for i in pick]
    gaps = np.concatenate(ref.served_gaps(m, weights, sample, device))
    control_gaps = (np.concatenate(ref.control_gaps(m, weights, sample,
                                                    device))
                    if control else None)
    del weights
    log(f"reference over {len(pick)} requests ({len(gaps)} served "
        f"tokens): {time.perf_counter() - t_ref:.3f} s")
    check, correct = compare(cell, gaps, failed, nonfinite)
    weights_bytes = sum(nbytes(t.fmt, t.shape) for t in tensor_plan(m))
    result = {"correct": correct, "attempted": len(requests),
              "failed": failed, "metrics": metrics,
              "device": device_info(device, peak, run,
                                    weights_bytes
                                    + kv_rows * roofline.kv_row_bytes(m))}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
        result["trace_cost"] = trace_cost
    result["setup"] = {"kernels_built": built, **parts,
                       "host_peak_bytes": host_peak}
    result["memory"] = {
        "weights_bytes": weights_bytes, "kv_rows_peak": kv_rows,
        "kv_reserved_bytes": m.max_batch * m.max_seq
        * roofline.kv_row_bytes(m)}
    result["window_capture_s"] = capture_in_window
    result["window_gc_s"] = sum(c.gc_s for c in run.calls)
    result["gaps"] = {"served_tokens": int(len(gaps)),
                      **{k: f(gaps) for k, f in GAP_NUMBERS.items()}}
    if control:
        result["control_gaps"] = {k: f(control_gaps)
                                  for k, f in GAP_NUMBERS.items()}
        result["control_check"], result["control_correct"] = compare(
            cell, control_gaps, 0, 0)
    result["check"] = check
    return result


def compare(cell: Cell, gaps, failed: int, nonfinite: int):
    """The check: the gap numbers the cell's limits file lists, then what
    every cell checks; a cell whose file lists no gap number is not
    correct. Returns (each number beside its limit, correct)."""
    check = {name: {"value": GAP_NUMBERS[name](gaps),
                    "limit": cell.limits[name]}
             for name in GAP_NUMBERS if name in cell.limits}
    gap_checked = bool(check)
    check["failed_requests"] = {"value": failed, "limit": 0}
    check["nonfinite_calls"] = {"value": nonfinite, "limit": 0}
    return check, gap_checked and all(c["value"] <= c["limit"]
                                      for c in check.values())


def log_call(log, index: int, rec: Call, what: str = "") -> None:
    log(f"call {index}{what}: {rec.t1 - rec.t0:.3f} s, prefill "
        f"{rec.stats['prefill_s']:.3f} s, decode {rec.stats['decode_s']:.3f}"
        f" s, capture {rec.stats['capture_s']:.3f} s, gc {rec.gc_s:.3f} s")


def device_info(device, peak: int, run: Run, filled: int) -> dict:
    """`memory_filled_bytes` beside the peak: the weights as stored and
    the most cache rows the window's requests held at once (the peak
    also counts the cache reserved for max_batch x max_seq rows)."""
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak),
                "memory_filled_bytes": int(filled),
                "power_limit_w": power_limit_w()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, "memory_filled_bytes": int(filled)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def print_result(result: dict) -> None:
    """The check's numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard out."""
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

