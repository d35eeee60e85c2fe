"""The engine's spans (`gguf_tpu_torch/engine/trace.py`, `LLM.tracer`) on
the CPU: off by default and silent when off, the same tokens and stats
with it on, a span tree whose parents contain their children, the
admissions in order, the `prefill` and `decode_chunk` spans summing to
`prefill_s` and `decode_s` exactly, the chunk widths the spans carry, and
the prefill counters of `stats` (prompt tokens, widths, host syncs).

`test_sync_count_matches_torch_on_the_card` runs on a CUDA device only:
it holds `llama.host_syncs` against the syncs torch's sync debug mode
reports. This file imports no jax, so it runs on the card without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import warnings
from collections import Counter

import pytest
import torch

from gguf_tpu_torch.engine import LLM, SamplerConfig
from gguf_tpu_torch.engine import engine as engine_mod
from gguf_tpu_torch.engine.trace import Tracer
from gguf_tpu_torch.models import LlamaConfig, llama, write_random_llama_gguf

CFG = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_dim=512, max_seq_len=1024)
# five requests over two slots (three admission sweeps): chunks of 8
# (<= 16 tokens: the K3 insert), 32 and 64 (> 16: `_cache_update`'s
# scatter), and a 600-token prompt in two chunks (512 and a 128-token
# tail)
PROMPT_LENS = (3, 20, 12, 600, 40)
NEW = 9          # 8 decoded tokens a request: two whole 4-step chunks
PARENT = {"admit": "generate", "prefill": "admit",
          "prefill_chunk": "prefill", "decode_chunk": "generate",
          "copy_in": "decode_chunk", "replay": "decode_chunk",
          "read": "decode_chunk", "emit": "generate", "flush": "generate"}
# a capture (on the card only) sits in the chunk whose key is new
CAPTURE_PARENTS = ("decode_chunk", "prefill_chunk")


def _prompts():
    g = torch.Generator().manual_seed(3)
    return [torch.randint(0, CFG.vocab_size, (n,), generator=g).tolist()
            for n in PROMPT_LENS]


def _widths(n: int, max_seq: int) -> list:
    """The padded widths `_prefill_chunks` takes for an n-token prompt at
    position 0 (PREFILL_CHUNK pieces, power-of-two tails from 8)."""
    out, off = [], 0
    while off < n:
        tp = min(max(8, 1 << (n - off - 1).bit_length()),
                 engine_mod.PREFILL_CHUNK)
        while tp > max_seq - off:
            tp //= 2
        out.append(tp)
        off += min(n - off, tp)
    return out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_trace") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, seed=0)
    return path


@pytest.fixture(scope="module")
def llm(checkpoint):
    return LLM(checkpoint, max_batch=2, max_seq=1024, device="cpu")


def _call(llm, on: bool, **kwargs):
    """One generate call with the tracer on or off: (results, spans,
    on_tokens calls)."""
    llm.tracer.enabled = on
    calls = []
    kwargs.setdefault("on_tokens", lambda *a: calls.append(a))
    try:
        res = llm.generate(_prompts(), max_new_tokens=NEW, decode_chunk=4,
                           **kwargs)
    finally:
        llm.tracer.enabled = False
    return res, llm.tracer.drain(), calls


@pytest.fixture(scope="module")
def traced(llm):
    """A greedy call without EOS stop, tracer on."""
    return _call(llm, True, stop_at_eos=False)


def test_tracer_is_off_by_default_and_records_nothing_off(llm):
    assert Tracer().enabled is False and llm.tracer.enabled is False
    tr = Tracer()
    assert tr.span("a") is tr.span("b", 5, x=1)       # one shared no-op
    with tr.span("a") as sp:
        sp.end(7)
    _call(llm, False)
    assert tr.drain() == [] and llm.tracer.drain() == []


ARGS = {"greedy": {},
        "no_eos_logprobs": {"stop_at_eos": False, "logprobs": 2},
        "sampled": {"sampler": SamplerConfig(temperature=0.8, top_k=20),
                    "seed": 7, "on_tokens": None}}


@pytest.mark.parametrize("name", list(ARGS))
def test_tracing_changes_no_output(llm, name):
    """Tokens, logprobs, stop reasons, what `on_tokens` saw and the stats'
    keys are the same with the tracer on and off."""
    off, none, calls_off = _call(llm, False, **ARGS[name])
    on, spans, calls_on = _call(llm, True, **ARGS[name])
    assert none == [] and spans
    for a, b in zip(off, on):
        assert (a.token_ids, a.finished, a.stop_reason, a.logprobs) == \
            (b.token_ids, b.finished, b.stop_reason, b.logprobs)
    assert calls_off == calls_on
    assert sorted(off[0].stats) == sorted(on[0].stats)
    for key in ("new_tokens", "decode_tokens", "prefill_tokens",
                "prefill_widths", "prefill_syncs", "decode_finite"):
        assert off[0].stats[key] == on[0].stats[key], key
    assert "tokens_per_s" not in on[0].stats


def test_span_tree(traced):
    """One root; every other span's parent exists, is the layer above it
    and contains it; ids are unique."""
    res, spans, _ = traced
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["generate"]
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.name in (CAPTURE_PARENTS if s.name == "capture"
                          else (PARENT[s.name],)), (s, p)
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    names = Counter(s.name for s in spans)
    assert names["prefill"] == len(res) == len(PROMPT_LENS)
    assert names["admit"] == 3
    assert names["decode_chunk"] == names["copy_in"] == names["replay"] \
        == names["read"] == names["emit"]
    assert names["capture"] == 0          # nothing is captured on the CPU


def test_request_times_in_order(traced):
    """Requests are admitted in order, one `prefill` span each, from the
    call's start (its queue wait is the span's start less the root's);
    the prefills of one sweep run back to back, and its first tokens are
    delivered by the flush after it, before any later sweep."""
    res, spans, calls = traced
    root = next(s for s in spans if s.name == "generate")
    prefills = sorted((s for s in spans if s.name == "prefill"),
                      key=lambda s: s.start_ns)
    waits = [s.start_ns - root.start_ns for s in prefills]
    assert waits == sorted(waits) and waits[0] >= 0
    for a, b in zip(prefills, prefills[1:]):
        assert a.end_ns <= b.start_ns
    admits = sorted((s for s in spans if s.name == "admit"),
                    key=lambda s: s.start_ns)
    flushes = sorted(s.start_ns for s in spans if s.name == "flush")
    for a, b in zip(admits, admits[1:] + [root]):
        after = [t for t in flushes if t >= a.end_ns]
        assert after and (b is root or after[0] < b.start_ns)
    # that flush delivers each admitted request's first token alone
    first: dict = {}
    for rid, ids, _ in calls:
        first.setdefault(rid, ids)
    assert first == {i: r.token_ids[:1] for i, r in enumerate(res)}


def test_spans_sum_to_stats_exactly(traced):
    res, spans, _ = traced
    st = res[0].stats
    for name, key in (("decode_chunk", "decode_s"), ("prefill", "prefill_s")):
        total = sum(s.end_ns - s.start_ns for s in spans if s.name == name)
        assert total / 1e9 == st[key], name


def test_prefill_chunk_counts(traced, llm):
    """Each request's chunks carry `_prefill_chunks`' buckets as their
    widths (the requests are admitted in order), and the stats count the
    prompt tokens and the same widths."""
    res, spans, _ = traced
    chunks = [s for s in spans if s.name == "prefill_chunk"]
    prefills = sorted((s for s in spans if s.name == "prefill"),
                      key=lambda s: s.start_ns)
    for p, n in zip(prefills, PROMPT_LENS):
        mine = sorted((s for s in chunks if s.parent == p.id),
                      key=lambda s: s.start_ns)
        assert [s.attrs for s in mine] == \
            [{"t": t} for t in _widths(n, llm.max_seq)]
    st = res[0].stats
    assert st["prefill_tokens"] == sum(PROMPT_LENS)
    assert st["prefill_widths"] == dict(Counter(s.attrs["t"] for s in chunks))


def test_decode_chunk_counts(traced):
    """Without the EOS stop and with whole chunks (NEW - 1 a multiple of
    decode_chunk), every decoded token is counted; each decode chunk runs
    its copy in, replay and read in that order, and an emit follows it
    before the next one."""
    res, spans, _ = traced
    st = res[0].stats
    assert st["decode_tokens"] == len(PROMPT_LENS) * (NEW - 1)
    decode = sorted((s for s in spans if s.name == "decode_chunk"),
                    key=lambda s: s.start_ns)
    emits = sorted(s.start_ns for s in spans if s.name == "emit")
    for i, d in enumerate(decode):
        kids = sorted((s for s in spans if s.parent == d.id),
                      key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["copy_in", "replay", "read"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert all(k.attrs == {} for k in kids) and d.attrs == {}
        nxt = decode[i + 1].start_ns if i + 1 < len(decode) else None
        assert d.end_ns <= emits[i] and (nxt is None or emits[i] < nxt)


@pytest.mark.parametrize("logprobs", [0, 2])
def test_host_syncs(llm, logprobs):
    """A prefill chunk of any width syncs nothing (its inputs go through
    the static buffers, its cache writes scatter at a device position);
    each prefill syncs once, the first token's read (and the logprobs'
    three), each decode chunk once, its read; `stats["prefill_syncs"]`
    counts the prefills' and the counter's change over the call adds the
    decode chunks'. Every chunk of a key run before counts in
    `prefill_replays`."""
    before = llama.host_syncs
    keys = len(llm.graphs.prefill_keys())
    res, spans, _ = _call(llm, True, stop_at_eos=False, logprobs=logprobs)
    want = len(PROMPT_LENS) * (1 + (3 if logprobs else 0))
    assert res[0].stats["prefill_syncs"] == want
    assert res[0].stats["prefill_replays"] == sum(
        len(_widths(n, llm.max_seq)) for n in PROMPT_LENS) - (
        len(llm.graphs.prefill_keys()) - keys)
    chunks = sum(s.name == "decode_chunk" for s in spans)
    assert llama.host_syncs - before == want + chunks


def test_request_spans_without_on_tokens(llm, traced):
    """Without `on_tokens` no flush span is recorded, and the other spans
    are those of the call with it."""
    res, spans, _ = _call(llm, True, stop_at_eos=False, on_tokens=None)
    names = Counter(s.name for s in spans)
    assert names["flush"] == 0
    want = Counter(s.name for s in traced[1])
    del want["flush"]
    assert names == want


def test_tracer_nesting_and_errors():
    """A span nests under the open one; a span an exception leaves
    open is dropped with its parent's close; `drain` empties."""
    tr = Tracer()
    tr.enabled = True
    with tr.span("outer", 10, a=1) as outer:
        with tr.span("leaf", 11, b=2) as leaf:
            leaf.end(12)
        try:
            with tr.span("mid"):
                tr.span("left_open")
                raise KeyError
        except KeyError:
            pass
        outer.end(99)
    spans = tr.drain()
    assert [s.name for s in spans] == ["leaf", "mid", "outer"]
    leaf, mid, outer_s = spans
    assert (outer_s.start_ns, outer_s.end_ns) == (10, 99)
    assert (leaf.start_ns, leaf.end_ns) == (11, 12)
    assert outer_s.attrs == {"a": 1} and leaf.attrs == {"b": 2}
    assert leaf.parent == mid.parent == outer_s.id and outer_s.parent is None
    assert tr.drain() == [] and tr._open == []


@pytest.mark.card
def test_sync_count_matches_torch_on_the_card(checkpoint):
    """On the card, under `torch.cuda.set_sync_debug_mode("warn")`: the
    change of `llama.host_syncs` over a replayed 64-token prefill chunk
    (0), over a decode chunk that captures its graph and over one that
    replays it (1, the read), and over a whole traced `generate` call,
    equals the syncs torch reports. One `capture` span per new graph key,
    with its steps and span (decode) or t and span (prefill); the tokens
    with the tracer on equal those with it off (the replays are
    bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("counts the syncs torch reports on a CUDA device")
    llm = LLM(checkpoint, max_batch=2, max_seq=1024, device="cuda")
    prompts = _prompts()
    llm.tracer.enabled = True
    on = llm.generate(prompts, max_new_tokens=NEW, decode_chunk=4,
                      stop_at_eos=False)
    spans = llm.tracer.drain()
    by_id = {s.id: s for s in spans}
    captures = {kind: sorted((s.attrs[first], s.attrs["span"])
                             for s in spans if s.name == "capture"
                             and by_id[s.parent].name == f"{kind}_chunk")
                for kind, first in (("decode", "steps"), ("prefill", "t"))}
    assert captures["decode"] == sorted(k[:2] for k in llm.graphs.keys())
    assert captures["prefill"] == sorted(
        k[:2] for k in llm.graphs.prefill_keys())
    assert captures["decode"] and captures["prefill"]
    llm.tracer.enabled = False
    off = llm.generate(prompts, max_new_tokens=NEW, decode_chunk=4,
                       stop_at_eos=False)
    assert [r.token_ids for r in on] == [r.token_ids for r in off]

    def reported(fn):
        """(syncs torch reports, change of llama.host_syncs) over fn()."""
        n0 = llama.host_syncs
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        hits = [w for w in seen if "synchroniz" in str(w.message)]
        return len(hits), llama.host_syncs - n0

    llm.tracer.enabled = True
    ids = prompts[3][:64]
    llm._prefill_chunks(ids, 1)                   # captures (64, 128)
    replays = llm.graphs.prefill_replays
    got, counted = reported(lambda: llm._prefill_chunks(ids, 0))
    chunk = [s for s in llm.tracer.drain() if s.name == "prefill_chunk"]
    assert [s.attrs["t"] for s in chunk] == [64, 64]
    assert llm.graphs.prefill_replays == replays + 1
    assert got == counted == 0
    tok, pos = [5, 6], [64, 1024]             # slot 1 inactive
    for steps in (8, 8):                      # a new key, then its replay
        n_keys = len(llm.graphs.keys())
        got, counted = reported(lambda: llm._decode(
            tok, pos, SamplerConfig(), steps, 128, llm.generator))
        assert got == counted == 1, (steps, n_keys)
    assert len([s for s in llm.tracer.drain() if s.name == "capture"]) == 1
    got, counted = reported(lambda: llm.generate(
        prompts, max_new_tokens=NEW, decode_chunk=4, stop_at_eos=False))
    assert got == counted
    llm.tracer.enabled = False
