"""The readers of the program's prefill counters and the reductions of its
spans: on synthetic runs and spans, against a program without the
counters (the metrics are left out, nothing raises), and one toy run of
`perfbench/checks/engine_spans.py` on the CPU.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from gguf_tpu_torch.engine.trace import Span
from perfbench import harness, roofline
from perfbench import program_spans as P
from perfbench.checks.engine_spans import summary, traced_run
from perfbench.checks.rehearse import toy
from perfbench.harness import load_cell, reader, run_cell
from perfbench.trace import Trace

NEW_METRICS = ("prefill_token_use.chat", "prefill_token_use.long_prompt",
               "prefill_syncs_per_ktok.chat",
               "prefill_syncs_per_ktok.long_prompt",
               "prefill_mmq_roofline.long_prompt")
COUNTERS = ("prefill_tokens", "prefill_widths", "prefill_syncs")


def _run(stats, trace=None):
    model = load_cell("mistral7b_q4km.long_prompt").model
    calls = [SimpleNamespace(stats=dict(s)) for s in stats]
    return SimpleNamespace(model=model, calls=calls, trace=trace)


def _trace(kernels, decode):
    """A Trace of (name, start, end) kernels and harness decode spans."""
    names = sorted({k[0] for k in kernels})
    idx = np.array([names.index(k[0]) for k in kernels], np.int64)
    s = np.array([k[1] for k in kernels], np.int64)
    e = np.array([k[2] for k in kernels], np.int64)
    d = np.array(decode, np.int64).reshape(-1, 2)
    return Trace((0, 10**9), (names, idx, s, e),
                 {"prefill": (np.zeros(0, np.int64), np.zeros(0, np.int64)),
                  "decode": (d[:, 0], d[:, 1])})


def test_prefill_counter_readers():
    stats = [{"prefill_tokens": 600, "prefill_widths": {512: 1, 128: 1},
              "prefill_syncs": 70},
             {"prefill_tokens": 40, "prefill_widths": {64: 1},
              "prefill_syncs": 35}]
    run = _run(stats)
    assert reader("prefill_token_use.chat").read(run) == \
        pytest.approx(100.0 * 640 / 704)
    assert reader("prefill_syncs_per_ktok.long_prompt").read(run) == \
        pytest.approx(1e3 * 105 / 640)
    # MMQ kernels outside the decode spans are the prefill's; the bound
    # is the last call's widths
    ns = 10**6
    trace = _trace([("mmq_q4_k_tc", 0, 4 * ns), ("add_splits", 4 * ns, 5 * ns),
                    ("mmq_q4_k_tc", 20 * ns, 21 * ns),    # in a decode span
                    ("elementwise_kernel", 5 * ns, 9 * ns)],
                   decode=[(19 * ns, 30 * ns)])
    run = _run(stats, trace)
    bound = roofline.mmq_bound_s(run.model, 64)
    assert reader("prefill_mmq_roofline.long_prompt").read(run) == \
        pytest.approx(100.0 * bound / 5e-3)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_without_the_counters(name):
    """A program without the counters (the parent): None, not a raise."""
    stats = [{"prefill_s": 1.0, "decode_s": 1.0, "decode_tokens": 8}]
    trace = _trace([("mmq_q4_k_tc", 0, 10)], decode=[(20, 30)])
    assert reader(name).read(_run(stats, trace)) is None


def test_harness_leaves_the_metrics_out_for_a_program_without_them(
        monkeypatch):
    """The toy long_prompt cell through the whole traced run, its program
    without the prefill counters (the harness never reads `LLM.tracer`):
    the result line holds the accepted metrics and none of the new
    ones."""
    import gguf_tpu_torch.engine as engine

    class Parent(engine.LLM):
        def generate(self, *args, **kwargs):
            out = super().generate(*args, **kwargs)
            for key in COUNTERS:
                out[0].stats.pop(key)
            return out

    monkeypatch.setattr(engine, "LLM", Parent)
    cell = toy(load_cell("mistral7b_q4km.long_prompt"))
    res = run_cell(cell, 2**31 + 5, 0.0, True, time.perf_counter(),
                   device="cpu", log=lambda s: None)
    assert res["correct"]
    assert "prefill_ms_per_ktok.long_prompt" in res["metrics"]
    assert not set(NEW_METRICS) & set(res["metrics"])


def _span(i, name, t0, t1, parent=None, **attrs):
    return Span(name, t0, t1, i, parent, attrs)


SPANS = [
    _span(1, "admit", 10, 40, 0),
    _span(2, "prefill", 10, 40, 1),
    _span(3, "prefill_chunk", 12, 35, 2, t=32),
    _span(4, "decode_chunk", 50, 70, 0),
    _span(5, "copy_in", 50, 52, 4), _span(6, "capture", 52, 60, 4, steps=2,
                                          span=128),
    _span(7, "replay", 60, 61, 4), _span(8, "read", 61, 70, 4),
    _span(9, "emit", 70, 72, 0),
    _span(10, "decode_chunk", 75, 90, 0),
    _span(11, "copy_in", 75, 76, 10), _span(12, "replay", 76, 78, 10),
    _span(13, "read", 78, 90, 10),
    _span(0, "generate", 5, 100),
]


def test_span_reductions():
    assert P.queue_waits_ms(SPANS) == [5e-6]
    assert P.decode_turnarounds_ms(SPANS) == [(78 - 70) / 1e6]
    assert P.captures(SPANS) == [[2, 128, 8e-9]]


def test_idle_by_innermost_span():
    """Idle intervals cut at the phases' bounds: (0, 12) is 5 outside,
    5 generate, 2 admit/prefill; (60, 80) is replay, read, emit,
    generate, then the second chunk's copy_in, replay and read; (98, 110)
    2 generate and 10 outside."""
    phases = P.Phases(SPANS, offset_ns=0)
    idle = phases.idle_by_span([0, 60, 98], [12, 80, 110], (0, 110))
    want = {"outside": 15, "generate": 5 + 3 + 2, "admit/prefill": 2,
            "decode_chunk/replay": 1 + 2, "decode_chunk/read": 9 + 2,
            "emit": 2, "decode_chunk/copy_in": 1}
    assert idle == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert [phases.name(int(i)) for i in phases.innermost([13, 55, 73])] \
        == ["prefill/prefill_chunk", "decode_chunk/capture", "generate"]
    shifted = P.Phases(SPANS, offset_ns=1000)
    assert shifted.idle_by_span([1060], [1061], (1000, 1110)) == \
        {"decode_chunk/replay": 1e-9}


def test_toy_run_of_the_check():
    """The check's run of the toy long_prompt cell on the CPU: correct,
    the new metrics in its result, spans in every call, and the idle
    time inside `generate` named."""
    cell = toy(load_cell("mistral7b_q4km.long_prompt"))
    run = traced_run(cell, 2**31 + 77, 0.0, True, True, "cpu")
    out = summary(cell, run, True)
    assert out["correct"]
    assert {"prefill_token_use.long_prompt",
            "prefill_syncs_per_ktok.long_prompt"} <= set(out["metrics"])
    assert all(n > 0 for n in out["spans_per_call"])
    assert out["queue_wait_p90_ms"] > 0 and out["decode_turnaround_ms"] > 0
    assert out["idle_in_generate_below_root"] > 0.9
    # the harness's own functions are restored
    assert harness.serve.__module__ == "perfbench.harness"
