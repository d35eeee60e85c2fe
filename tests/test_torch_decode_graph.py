"""The port's decode chunk (`engine/decode_graph.py`) and the chunk
arguments of `generate`, on the CPU, against the JAX package's
`LLM.generate` at the 2-layer config of `test_torch_engine.py`: greedy ids
at decode_chunk 1, 2 and 8, stop_at_eos, stop_ids and on_tokens (ids,
stop reasons, streamed pieces), logprobs=2; and the runner itself: its
static buffers against the eager loop over two calls of one bucket, its
bucket keys, and seeded sampling from the engine's own generator.

On the CPU the runner captures nothing and runs the same chunk on the
same static buffers the card's graphs read and write; the card's graph
replays are held against the eager loop by chip_smoke.py."""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import toy_spm_metadata
from gguf_tpu.engine import LLM as JaxLLM
from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import init_kv_cache as jax_init_cache
from gguf_tpu_torch.engine import LLM, SamplerConfig
from gguf_tpu_torch.models import MMOpts, write_random_llama_gguf
from test_torch_engine import CFG, FORWARD_TOL, NEW, PROMPT_LENS

MAX_BATCH, MAX_SEQ = 4, 256
# (decode_chunk, stop_at_eos, with stop_ids) of each generate call held
# against the JAX package's, every one with logprobs=2 and on_tokens
RUNS = {"chunk1": (1, False, False), "chunk2": (2, False, False),
        "chunk8": (8, False, False), "eos": (8, True, False),
        "stop_ids": (8, False, True)}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, CFG.vocab_size, n)]
            for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 2-layer checkpoint with a tokenizer whose EOS id is a token the
    greedy run emits mid-sequence (so stop_at_eos acts), and a stop id
    it emits in another request: picked from a greedy run of the same
    weights without a tokenizer (the writer draws the weights first, so
    the metadata leaves them unchanged), in the two requests whose first
    8 steps keep the widest top-2 logprob gaps, away from near-ties."""
    tmp = tmp_path_factory.mktemp("torch_decode_graph")
    plain = str(tmp / "plain.gguf")
    write_random_llama_gguf(plain, CFG, seed=0)
    free = LLM(plain, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    res = free.generate(_prompts(), NEW, logprobs=2)
    margin = [min(e["top"][0][1] - e["top"][1][1] for e in r.logprobs[:8])
              for r in res]
    first, second = np.argsort(margin)[::-1][:2]
    eos, stop = res[first].token_ids[5], res[second].token_ids[6]
    assert eos != stop
    path = str(tmp / "eos.gguf")
    md = toy_spm_metadata(CFG.vocab_size)
    md["tokenizer.ggml.eos_token_id"] = int(eos)
    write_random_llama_gguf(path, CFG, seed=0, extra_metadata=md)
    return path, stop


@pytest.fixture(scope="module")
def runs(setup):
    """Every call of RUNS through both engines: (JAX results, JAX stream,
    port results, port stream), and the near-tie bound on logit gaps."""
    path, stop = setup
    jllm = JaxLLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                  prefix_cache=False)
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    assert llm.eos_id == jllm.tokenizer.eos_id
    prompts = _prompts()
    out = {}
    for name, (chunk, at_eos, with_stop) in RUNS.items():
        pair = []
        for engine in (jllm, llm):
            stream = []
            res = engine.generate(
                prompts, max_new_tokens=NEW, decode_chunk=chunk,
                stop_at_eos=at_eos, stop_ids=[stop] if with_stop else None,
                logprobs=2,
                on_tokens=lambda i, new, done, s=stream:
                    s.append((i, list(new), done)))
            pair += [res, stream]
        out[name] = tuple(pair)
    logits, _ = jax_forward(jllm.params, jllm.cfg,
                            jnp.asarray([prompts[-1]], jnp.int32),
                            jnp.zeros(1, jnp.int32),
                            jax_init_cache(jllm.cfg, 1, MAX_SEQ))
    return out, FORWARD_TOL * float(jnp.abs(logits).max())


def _compared(ref, gap_tol):
    """Steps of each reference result before its first near-tie (top-2
    logit gap under gap_tol), where the greedy choice may go either way."""
    steps = []
    for r in ref:
        gaps = [e["top"][0][1] - e["top"][1][1] for e in r.logprobs]
        steps.append(next((j for j, g in enumerate(gaps) if g < gap_tol),
                          len(gaps)))
    return steps


@pytest.mark.parametrize("name", ["chunk1", "chunk2", "chunk8"])
def test_decode_chunk_matches_jax(runs, name):
    """Greedy ids at decode_chunk 1, 2 and 8 equal the JAX call's with the
    same decode_chunk, and each other, up to the reference's first
    near-tie."""
    out, gap_tol = runs
    ref, _, got, _ = out[name]
    base = out["chunk8"][2]
    steps = _compared(ref, gap_tol)
    for r, g, b, n in zip(ref, got, base, steps):
        assert len(g.token_ids) == NEW and g.stop_reason == "length"
        assert g.token_ids[:n] == r.token_ids[:n] == b.token_ids[:n]
    assert sum(steps) >= 2 * NEW, steps


@pytest.mark.parametrize("name", ["eos", "chunk8", "stop_ids"])
def test_stop_arguments_and_streaming(runs, name):
    """stop_at_eos (on, and off in "chunk8") and stop_ids give the JAX
    call's ids and stop reasons, and on_tokens its pieces; each request's
    pieces join to its token_ids and its `finished` arrives once, last.
    A request is held whole where the reference has no near-tie (its
    ending then cannot go either way); the schedule, and so the pieces'
    lengths, is the reference's where every request's ending is fixed."""
    out, gap_tol = runs
    ref, ref_stream, got, stream = out[name]
    for i, g in enumerate(got):
        mine = [(new, done) for rid, new, done in stream if rid == i]
        assert sum((new for new, _ in mine), []) == g.token_ids
        assert [done for _, done in mine] == [False] * (len(mine) - 1) + [True]
        assert g.finished
    steps = _compared(ref, gap_tol)
    whole = [n == len(r.token_ids) for r, n in zip(ref, steps)]
    for r, g, n, full in zip(ref, got, steps, whole):
        assert g.token_ids[:n] == r.token_ids[:n]
        if full:
            assert g.token_ids == r.token_ids
            assert g.stop_reason == r.stop_reason
    if name == "chunk8" or all(whole):
        assert ([(i, len(new), done) for i, new, done in stream]
                == [(i, len(new), done) for i, new, done in ref_stream])
    if all(whole):
        assert stream == ref_stream
    reason = {"eos": "eos", "stop_ids": "stop", "chunk8": "length"}[name]
    assert any(full and g.stop_reason == reason
               for g, full in zip(got, whole)), (steps, whole)


def test_logprobs_match_jax(runs):
    """logprobs=2: one entry per generated token; the chosen token's and
    each top entry's logprob within 1e-2 * max|ref logit| of the JAX
    call's, and each top id equal unless the reference's logprob there
    and the next one are a near-tie."""
    out, gap_tol = runs
    ref, _, got, _ = out["chunk8"]
    for r, g, n in zip(ref, got, _compared(ref, gap_tol)):
        assert len(g.logprobs) == len(g.token_ids)
        for e, f in zip(r.logprobs[:n], g.logprobs[:n]):
            assert abs(e["logprob"] - f["logprob"]) <= gap_tol
            assert len(f["top"]) == 2
            ref_lp = [lp for _, lp in e["top"]]
            for r, ((rid, rlp), (gid, glp)) in enumerate(zip(e["top"],
                                                             f["top"])):
                assert abs(rlp - glp) <= gap_tol
                # the last entry's rival is not listed: a tie is possible
                tie = r + 1 == len(ref_lp) or ref_lp[r] - ref_lp[r + 1] < gap_tol
                assert gid == rid or tie, (e, f)


def _snapshot(cache):
    return [{n: c.clone() for n, c in layer.items()} for layer in cache]


def test_runner_static_buffers(setup):
    """One bucket run twice with other token ids and positions (a slot at
    pos = max_seq the second time): each time the eager loop's ids, and
    a cache bit-equal to the one the eager loop leaves from the same
    start."""
    path, _ = setup
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    for s, p in enumerate(_prompts(1)[:MAX_BATCH]):
        llm._prefill_chunks(p, s)
    greedy, rng = SamplerConfig(), np.random.default_rng(3)
    for pos in ([3, 8, 12, 20], [21, 9, MAX_SEQ, 13]):
        tok = rng.integers(0, CFG.vocab_size, MAX_BATCH)
        pos = np.asarray(pos)
        start = _snapshot(llm.cache)
        ids = llm._decode_eager(torch.as_tensor(tok),
                                torch.as_tensor(pos, dtype=torch.int32),
                                greedy, 4, 128, llm.generator)
        eager = _snapshot(llm.cache)
        for layer, old in zip(llm.cache, start):
            for n, c in layer.items():
                c.copy_(old[n])
        chunk = llm._decode(tok, pos, greedy, 4, 128, llm.generator)
        assert np.array_equal(chunk.ids, ids.numpy()) and chunk.finite
        assert chunk.logprob is None
        assert all(torch.equal(c, e[n]) for layer, e in zip(llm.cache, eager)
                   for n, c in layer.items())
    assert llm.graphs.keys() == [(4, 128, greedy, 0, MMOpts())]


def test_bucket_keys(setup):
    """A generate whose chunks end at every budget and cross a span
    bucket keeps the runner's keys to powers of two up to decode_chunk
    times the span buckets."""
    path, _ = setup
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    prompts = _prompts(2) + [list(range(1, 121))]   # decode past span 128
    llm.generate(prompts, max_new_tokens=NEW + 3, decode_chunk=4,
                 stop_at_eos=False)
    keys = llm.graphs.keys()
    assert {(s, span) for s, span, *_ in keys} <= {
        (s, span) for s in (1, 2, 4) for span in (128, 256)}
    assert {k[2:] for k in keys} == {(SamplerConfig(), 0, MMOpts())}
    assert {span for _, span, *_ in keys} == {128, 256}
    assert len({s for s, *_ in keys}) >= 2


def test_seeded_sampling_repeats(setup):
    """Temperature 0.8, top-k 40: the same seed gives the same ids whatever
    torch's global seed, another seed other ids."""
    path, _ = setup
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    sampler = SamplerConfig(temperature=0.8, top_k=40)

    def ids(seed, global_seed):
        torch.manual_seed(global_seed)
        return [r.token_ids for r in llm.generate(
            _prompts(4), max_new_tokens=8, sampler=sampler, seed=seed,
            stop_at_eos=False)]

    first = ids(3, 0)
    assert ids(3, 123) == first
    assert ids(4, 0) != first
    with pytest.raises(ValueError, match="generator"):
        llm._decode(np.zeros(MAX_BATCH), np.zeros(MAX_BATCH), sampler, 1,
                    128, torch.Generator())
