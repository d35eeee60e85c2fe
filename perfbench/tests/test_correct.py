"""The check that decides `correct`, at a size a CPU test run holds: each
cell's configuration at toy widths (`perfbench.checks.rehearse.toy`),
driven through the whole run but the look for a chip, with the timed
path broken underneath. Each fault the serving cells can have must turn
`correct` false under the cell's own limits: a decode step that leaves
its state (the KV cache) unchanged; half of the batch's slots left out
(their logits taken from the other half); a token altered where the
decode chunk produces it. A sound run passes the same limits. (The
cells run on one chip, so no exchange between chips can be left out.)

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from perfbench.checks.rehearse import toy
from perfbench.harness import ROOT, load_cell, run_cell

CELLS = [w["name"] for w in
         json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
SEED = 2**31 + 99


def run(cell):
    return run_cell(cell, SEED, 0.0, False, time.perf_counter(),
                    device="cpu", log=lambda s: None)


def state_unchanged(monkeypatch):
    """The t = 1 cache insert lands in copies: the cache keeps its rows."""
    from gguf_tpu_torch.models import llama

    real = llama.decode_attention_update

    def no_insert(q, k, v, ck, cks, cv, cvs, *args, **kwargs):
        return real(q, k, v, ck.clone(), cks.clone(), cv.clone(), cvs.clone(),
                    *args, **kwargs)

    monkeypatch.setattr(llama, "decode_attention_update", no_insert)


def half_batch(monkeypatch):
    """The decode step computes the first half of the slots and hands
    their logits to the other half."""
    from gguf_tpu_torch.engine import decode_graph

    real = decode_graph.forward

    def halved(params, cfg, tokens, pos, cache, *args, **kwargs):
        logits, cache = real(params, cfg, tokens, pos, cache, *args, **kwargs)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:half]]), cache

    monkeypatch.setattr(decode_graph, "forward", halved)


def token_altered(monkeypatch):
    """Every slot's token of a decode chunk's first step is the next id
    after the one sampled."""
    from gguf_tpu_torch.engine import decode_graph

    real, step = decode_graph.sample, [0]

    def altered(logits, *args, **kwargs):
        ids = real(logits, *args, **kwargs)
        step[0] += 1
        return (ids + 1) % logits.shape[-1] if step[0] % 8 == 1 else ids

    monkeypatch.setattr(decode_graph, "sample", altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = toy(load_cell(name))
    result = run(cell)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = toy(load_cell(name))
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"], result["check"]
    assert any(result["check"][k]["value"] > cell.limits[k]
               for k in ("max_gap", "mean_gap") if k in cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_separates(name):
    """The control (the reference with float8 e4m3 activations in the
    program's place) lies farther below the f32 reference's best than the
    program's served tokens do, by the mean gap: at toy size by 3x or
    more over three seeds, and its gaps go through the same comparison
    as the program's (`control_check`). At the cells' size it fails the
    committed limits: `test_fp8_control_is_not_correct_on_the_card`."""
    cell = toy(load_cell(name))
    program, control = [], []
    for seed in (1, 2, 3):
        r = run_cell(cell, seed, 0.0, False, time.perf_counter(),
                     device="cpu", control=True, log=lambda s: None)
        program.append(r["gaps"]["mean_gap"])
        control.append(r["control_gaps"]["mean_gap"])
        assert r["control_check"]["mean_gap"]["value"] == control[-1]
        assert r["control_correct"] == (control[-1] <= cell.limits["mean_gap"])
    assert max(control) >= 3 * max(program), (program, control)


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="reads the control at the cell's own size, "
                           "which only the card holds")
@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_is_not_correct_on_the_card(name):
    """At the cell's own size and load (its checkpoint, the warm-up call
    and one call of its traffic, the sample a run draws), on three seeds:
    the program is correct and the fp8 control, put through the same
    comparison under the committed limits, is not. Each seed's numbers
    are printed as one JSON line (`pytest -s`)."""
    cell = load_cell(name)
    for seed in (2**31 + 7001, 2**31 + 7002, 2**31 + 7003):
        r = run_cell(cell, seed, 0.0, False, time.perf_counter(),
                     control=True, log=lambda s: None)
        print(json.dumps({"workload": name, "seed": seed,
                          "correct": r["correct"], "check": r["check"],
                          "control_correct": r["control_correct"],
                          "control_check": r["control_check"],
                          "gaps": r["gaps"],
                          "control_gaps": r["control_gaps"]}), flush=True)
        assert r["correct"], r["check"]
        assert not r["control_correct"], r["control_check"]
