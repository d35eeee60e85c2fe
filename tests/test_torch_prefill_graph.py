"""The port's prefill chunk on the graphs' static buffers
(`engine/decode_graph.py:ChunkGraphs.prefill`), on the CPU: logits and
cache bytes bit-equal to the eager chunk over views of the slot's rows
(`LLM._prefill_eager`) at every padded width, in the first and the last
slot, from position 0 and from a start whose insert clamps at S - T, for
prompts of 1, 2 and 5 chunks; every other slot's rows untouched; the
cache scatter of the t > 16 arm equal to the per-sequence slice writes it
replaced, clamp included; K3 and K4 handed the slot's row index; and
`generate` over several chunks a prompt against the JAX package's, as
`test_torch_engine.py` holds it.

On the CPU nothing is captured: the same code runs on the same static
buffers the card's graphs read and write. The `card` tests hold the
replays against the eager chunk on a CUDA device, at two layers of
Mistral-7B's and of SmolLM2-1.7B's widths. This file imports no jax at
module level, so they run there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_prefill_graph.py
"""

import numpy as np
import pytest
import torch

from gguf_tpu_torch.engine import LLM
from gguf_tpu_torch.engine import engine as engine_mod
from gguf_tpu_torch.engine.decode_graph import ChunkGraphs
from gguf_tpu_torch.engine.trace import Tracer
from gguf_tpu_torch.models import GGMLType, LlamaConfig, write_random_llama_gguf
from gguf_tpu_torch.models import llama
from gguf_tpu_torch.ops import attention as ATT
from gguf_tpu_torch.ops import build
from gguf_tpu_torch.ops.attention import quantize_kv

CFG = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_dim=512, max_seq_len=4096)
SLOTS, S = 3, 4096
WIDTHS = (8, 16, 32, 64, 128, 256, 512)


@pytest.fixture(scope="module")
def llm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_prefill_graph") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, seed=0)
    return LLM(path, max_batch=SLOTS, max_seq=S, device="cpu")


def _fill(cache, seed: int) -> None:
    """Every row of every slot random: codes in +-127, small scales."""
    g = torch.Generator().manual_seed(seed)
    for layer in cache:
        for name, c in layer.items():
            if c.dtype == torch.int8:
                c.copy_(torch.randint(-127, 128, c.shape, generator=g,
                                      dtype=torch.int8))
            else:
                c.copy_(torch.rand(c.shape, generator=g) * 0.02)


def _snapshot(cache):
    return [{n: c.clone() for n, c in layer.items()} for layer in cache]


def _restore(cache, saved) -> None:
    for layer, old in zip(cache, saved):
        for n, c in layer.items():
            c.copy_(old[n])


def _equal(cache, ref) -> bool:
    return all(torch.equal(c, r[n]) for layer, r in zip(cache, ref)
               for n, c in layer.items())


def _both(llm, run, seed: int):
    """run(i) from one random cache twice, the eager chunk in place of
    `_prefill` the first time (i = 0): [(logits, cache) of each run]."""
    _fill(llm.cache, seed)
    saved = _snapshot(llm.cache)
    out = []
    for i in range(2):
        _restore(llm.cache, saved)
        if i == 0:
            llm._prefill = llm._prefill_eager
        try:
            logits = run(i).clone()
        finally:
            llm.__dict__.pop("_prefill", None)
        out.append((logits, _snapshot(llm.cache)))
    return out


# (prompt tokens, slot, start): a prompt of each padded width (a padded
# tail), in the first and the last slot, at 0 and further in; then
# prompts of 2 and 5 chunks
CHUNKS = {**{f"t{t}_slot{i % 2 * (SLOTS - 1)}": (t // 2 + 1,
                                                 i % 2 * (SLOTS - 1), 0)
             for i, t in enumerate(WIDTHS)},
          **{f"t{t}_start700_slot{i % 2}": (t - 1, i % 2, 700)
             for i, t in enumerate((16, 64, 512))},
          "two_chunks": (700, SLOTS - 1, 0),
          "five_chunks": (2100, 0, 0),
          "five_chunks_start900": (2100, SLOTS - 1, 900)}


@pytest.mark.parametrize("name", list(CHUNKS))
def test_prefill_chunks_match_eager(llm, name):
    """`_prefill_chunks` on the static buffers leaves the eager chunks'
    logits row and cache bytes, every slot's, and takes the widths the
    eager chunks take; every chunk but a key's first counts a replay."""
    n, slot, start = CHUNKS[name]
    ids = np.random.default_rng(n + start).integers(0, CFG.vocab_size, n)
    widths = [{}, {}]
    replays = llm.graphs.prefill_replays
    keys = len(llm.graphs.prefill_keys())
    (a, ca), (b, cb) = _both(
        llm, lambda i: llm._prefill_chunks(ids, slot, start, widths[i]),
        seed=n)
    assert torch.equal(a, b) and _equal(cb, ca)
    assert widths[0] == widths[1]
    new_keys = len(llm.graphs.prefill_keys()) - keys
    assert llm.graphs.prefill_replays - replays == \
        sum(widths[1].values()) - new_keys
    if name.startswith("five"):
        assert sum(widths[1].values()) == 5


@pytest.mark.parametrize("t", [8, 16, 17, 64, 512])
def test_clamped_insert_matches_eager(llm, t):
    """A chunk whose start lies past S - t: the t > 16 scatter clamps its
    rows to S - t as the eager slice writes did (the reference's
    dynamic_update_slice); K3 (t <= 16) skips the rows past S."""
    toks = np.random.default_rng(t).integers(0, CFG.vocab_size, (1, t))
    start = S - t + 5
    (a, ca), (b, cb) = _both(
        llm, lambda i: llm._prefill(toks.astype(np.int32), SLOTS - 1, start,
                                    t - 1, S), seed=t)
    assert torch.equal(a, b) and _equal(cb, ca)


def test_other_slots_untouched(llm):
    """Two prompts into the first and the last slot: the middle slot's
    rows, and the prefilled slots' rows past the padded chunks' end, keep
    their bytes."""
    _fill(llm.cache, 7)
    saved = _snapshot(llm.cache)
    rng = np.random.default_rng(7)
    # the padded chunks' end: 512 + 128 and 64 rows
    ends, want = {0: 640, SLOTS - 1: 64}, {0: {512: 1, 128: 1},
                                           SLOTS - 1: {64: 1}}
    for slot, n in ((0, 600), (SLOTS - 1, 45)):
        widths = {}
        llm._prefill_chunks(rng.integers(0, CFG.vocab_size, n), slot,
                            widths=widths)
        assert widths == want[slot]
    for layer, old in zip(llm.cache, saved):
        for name, c in layer.items():
            for slot in range(SLOTS):
                end = ends.get(slot, 0)
                assert torch.equal(c[slot, :, end:], old[name][slot, :, end:])
            assert not torch.equal(c[0, :, :600], old[name][0, :, :600])


def _loop_cache_update(cache_l, new_k, new_v, pos, rows):
    """The slice writes `_cache_update` made before its scatter, one
    sequence at a time at a start read on the host."""
    qk, sk = quantize_kv(new_k)
    qv, sv = quantize_kv(new_v)
    s, t = cache_l["k"].shape[2], new_k.shape[2]
    for b, (r, p) in enumerate(zip(rows, pos.tolist())):
        p = min(max(int(p), 0), s - t)
        cache_l["k"][r, :, p:p + t] = qk[b]
        cache_l["v"][r, :, p:p + t] = qv[b]
        cache_l["k_scale"][r, :, p:p + t] = sk[b]
        cache_l["v_scale"][r, :, p:p + t] = sv[b]


@pytest.mark.parametrize("t", [17, 512])
@pytest.mark.parametrize("rows", [None, (2, 0)])
def test_cache_scatter_matches_slice_writes(t, rows):
    """`_cache_update` at t = 17 and 512 for two sequences, one of them
    clamped at S - t, into rows 0 and 1 or, through `rows`, into rows 2
    and 0 of a three-row cache: the same bytes as the slice writes, and
    no host sync counted."""
    s, kvh, hd = 1024, 2, 64
    g = torch.Generator().manual_seed(t)
    cache = {n: torch.randint(-127, 128, (3, kvh, s, hd), generator=g,
                              dtype=torch.int8) for n in ("k", "v")}
    cache.update({n: torch.rand((3, kvh, s), generator=g)
                  for n in ("k_scale", "v_scale")})
    ref = {n: c.clone() for n, c in cache.items()}
    new_k = torch.randn((2, kvh, t, hd), generator=g)
    new_v = torch.randn((2, kvh, t, hd), generator=g).to(torch.bfloat16)
    pos = torch.tensor([3, s - t + 9], dtype=torch.int32)
    syncs = llama.host_syncs
    llama._cache_update(cache, new_k, new_v, pos,
                        None if rows is None
                        else torch.tensor(rows, dtype=torch.int32))
    assert llama.host_syncs == syncs
    _loop_cache_update(ref, new_k, new_v, pos, rows or (0, 1))
    assert all(torch.equal(cache[n], ref[n]) for n in cache)


class _FakeLib:
    """Records each C entry point's arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_k3_and_k4_take_the_row_index(monkeypatch):
    """K3's and K4's launches carry the row index tensor's pointer after
    `pos` (NULL without one), with the sequences' count as B."""
    lib = _FakeLib()
    monkeypatch.setattr(ATT, "_lib", lambda: lib)
    monkeypatch.setattr(ATT, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    monkeypatch.setattr(build, "ptr", lambda t: ("ptr", t.data_ptr()))
    kvh, hd, s, t = 2, 64, 256, 8
    k = torch.zeros((4, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((4, kvh, s))
    rows = torch.tensor([3], dtype=torch.int32)
    new = torch.zeros((1, kvh, t, hd))
    pos = torch.tensor([40], dtype=torch.int32)
    kw = dict(t=t, precision="fast", span=s, window=0, softcap=0.0)
    ATT._insert_cuda(new, new, k, sc, k.clone(), sc.clone(), pos, rows)
    ATT._attend_cuda(torch.zeros((1, kvh, t, hd)), None, None, k, sc,
                     k.clone(), sc.clone(), pos, rows=rows, **kw)
    ATT._attend_cuda(torch.zeros((4, kvh, t, hd)), None, None, k, sc,
                     k.clone(), sc.clone(), torch.zeros(4, dtype=torch.int32),
                     **kw)
    (k3, a3), (k4, a4), (k4b, a4b) = lib.calls
    assert (k3, k4, k4b) == ("kv_cache_insert_launch",
                             "decode_attention_launch",
                             "decode_attention_launch")
    assert a3[7] == ("ptr", rows.data_ptr()) and a3[8:12] == (1, kvh, t, s)
    assert a4[8] == ("ptr", rows.data_ptr()) and a4[10:12] == (1, kvh)
    assert a4b[8] is None and a4b[10] == 4


@pytest.mark.parametrize("fmt,chunk", [("q4_k", 32), ("q8_0", 16)])
def test_generate_over_chunks_matches_jax(tmp_path, monkeypatch, fmt, chunk):
    """`test_torch_engine.py`'s greedy parity against the JAX package's
    `generate`, with prompts of up to 70 tokens cut into chunks of 16 or
    32 (3-5 chunks a prompt), every chunk on the static buffers."""
    import test_torch_engine as te

    path = str(tmp_path / f"{fmt}.gguf")
    write_random_llama_gguf(path, te.CFG, fmt=GGMLType[fmt.upper()],
                            seed=5)
    monkeypatch.setattr(engine_mod, "PREFILL_CHUNK", chunk)
    compared = te._greedy_parity(path, te.JaxMMOpts(), te.MMOpts(),
                                 te.FORWARD_TOL, te.PROMPT_LENS, seed=6)
    assert compared >= 2 * te.NEW, compared


def _graphs_and_step():
    """A CPU `ChunkGraphs` over a 4-token vocabulary and a step whose
    logits are ones, or `bad` at chunk row 0 where given."""
    graphs = ChunkGraphs("cpu", 1, vocab=4, width=16)

    def step(bad=None):
        def run(tokens, pos, rows):
            logits = torch.ones((1, tokens.shape[1], 4))
            if bad is not None:
                logits[0, 0, 0] = bad
            return logits
        return run

    return graphs, step


def _chunk(graphs, key, step) -> torch.Tensor:
    t = key[0]
    return graphs.prefill(Tracer(), key, step, np.zeros((1, t), np.int32),
                          0, 0, t - 1)


def test_replays_count_only_keys_run_before():
    """A key's first chunk (its capture on the card) counts no replay;
    every later chunk of it does, whatever other keys ran between."""
    graphs, step = _graphs_and_step()
    for key, want in (((8, 128, None), 0), ((8, 128, None), 1),
                      ((16, 128, None), 1), ((8, 256, None), 1),
                      ((16, 128, None), 2), ((8, 128, None), 3)):
        _chunk(graphs, key, step())
        assert graphs.prefill_replays == want, key
    assert len(graphs.prefill_keys()) == 3


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_finite_flag_sees_every_logit_of_a_chunk(bad):
    """`prefill_finite` ANDs every logit of every chunk, not only the kept
    row: a non-finite logit in row 0 of a chunk that keeps its last row
    clears it, and it stays clear until the caller resets it."""
    graphs, step = _graphs_and_step()
    key = (8, 128, None)
    _chunk(graphs, key, step())
    assert bool(graphs.prefill_finite)
    row = _chunk(graphs, key, step(bad))
    assert torch.isfinite(row).all() and not bool(graphs.prefill_finite)
    _chunk(graphs, key, step())
    assert not bool(graphs.prefill_finite)
    graphs.prefill_finite.fill_(True)
    _chunk(graphs, key, step())
    assert bool(graphs.prefill_finite)


def test_a_repeated_call_replays_every_chunk(tmp_path):
    """`generate`'s `prefill_replays`: a fresh engine's first call counts
    every chunk but each key's first, the same prompts' second call every
    chunk (what `prefill_replay_share` reads as 100)."""
    path = str(tmp_path / "tiny.gguf")
    write_random_llama_gguf(path, CFG, seed=1)
    eng = LLM(path, max_batch=SLOTS, max_seq=S, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [[int(v) for v in rng.integers(0, CFG.vocab_size, n)]
               for n in (5, 40, 41, 600)]
    first, second = (eng.generate(prompts, max_new_tokens=2)[0].stats
                     for _ in range(2))
    chunks = sum(first["prefill_widths"].values())
    assert chunks == 5 and len(eng.graphs.prefill_keys()) == 4
    assert first["prefill_replays"] == chunks - 4
    assert second["prefill_replays"] == chunks
    assert second["prefill_widths"] == first["prefill_widths"]


# --------------------------------------------------------- on the card ---

CARD_CONFIGS = {
    "mistral7b": (LlamaConfig(vocab_size=32000, dim=4096, n_layers=2,
                              n_heads=32, n_kv_heads=8, ffn_dim=14336,
                              max_seq_len=2048, rope_theta=1e6),
                  GGMLType.Q4_K),
    "smollm2": (LlamaConfig(vocab_size=49152, dim=2048, n_layers=2,
                            n_heads=32, n_kv_heads=32, ffn_dim=8192,
                            max_seq_len=2048, rope_theta=130000.0),
                GGMLType.Q8_0),
}


@pytest.fixture(scope="module", params=list(CARD_CONFIGS))
def card_llm(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("replays CUDA graphs on a CUDA device")
    cfg, fmt = CARD_CONFIGS[request.param]
    path = str(tmp_path_factory.mktemp("prefill_card") / "two_layers.gguf")
    write_random_llama_gguf(path, cfg, fmt=fmt, seed=1)
    return LLM(path, max_batch=4, max_seq=cfg.max_seq_len, device="cuda")


@pytest.mark.card
@pytest.mark.parametrize("t", [8, 16, 64, 512])
def test_replayed_chunk_equals_eager_on_the_card(card_llm, t):
    """Slot 2 at start 700: the eager chunk, then from the same cache the
    chunk that captures its (t, span) graph and the one that replays it,
    each bit-equal to the eager one in its logits row and in every cache
    byte. t = 8 inserts by K3 and attends by K4, t = 16 inserts by K3,
    t = 64 and 512 by the scatter, each through the slot's row index."""
    llm = card_llm
    toks = np.random.default_rng(t).integers(
        0, llm.cfg.vocab_size, (1, t)).astype(np.int32)
    start, slot = 700, 2
    span = llm._span_bucket(start + t)
    _fill(llm.cache, t)
    saved = _snapshot(llm.cache)
    ref = llm._prefill_eager(toks, slot, start, t - 1, span).clone()
    ref_cache = _snapshot(llm.cache)
    keys = len(llm.graphs.prefill_keys())
    for call in ("capture", "replay"):
        _restore(llm.cache, saved)
        got = llm._prefill(toks, slot, start, t - 1, span).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, ref), call
        assert _equal(llm.cache, ref_cache), call
    assert len(llm.graphs.prefill_keys()) == keys + 1
    assert llm.graphs.prefill_graphs[(t, span, llm.opts)] is not None
    del saved, ref_cache
    torch.cuda.empty_cache()
