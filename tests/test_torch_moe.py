"""The port's routed FFN (mixtral family: `models/llama.py:moe_mlp`), its
loader and writer, held against the JAX package and the benchmark's
plain reference (`perfbench/references/mixtral.py`).

As `tests/test_moe.py` notes, top-k routing is discontinuous: a token
whose k-th and (k+1)-th experts nearly tie flips experts under any
rounding difference, which moves its output by the two experts'
disagreement and no tolerance absorbs. So the comparisons across
implementations run at k == E (softmax weights, smooth everywhere), and
the top-2 selection and renormalisation are pinned by a crafted router
whose margins are decisive by construction. The top-2 files (the
harness's toy and the writer's) keep a router whose logits have std
about 2, where a flip needs two logits within a rounding of each other.

The `card` tests run the routed FFN inside the CUDA graphs at two layers
of Mixtral-8x7B's widths (`perfbench/archs/mixtral.py`'s plan, seeded
block bytes). This file imports jax only inside the tests that compare
with it, so they run on the card without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_moe.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gguf_tpu_torch.engine import LLM
from gguf_tpu_torch.gguf import GGMLType, GGUFReader
from gguf_tpu_torch.models import (LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, write_random_llama_gguf)
from gguf_tpu_torch.models import llama
from gguf_tpu_torch.models.loader import check_tensors_loaded
from gguf_tpu_torch.quant.layouts import QuantWeight

# k == E: smooth routing, for the comparisons across implementations
SMOOTH = LlamaConfig(vocab_size=128, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=256, max_seq_len=64,
                     n_experts=4, n_experts_used=4)
TOP2 = dataclasses.replace(SMOOTH, n_experts_used=2, max_seq_len=256)
# logits vs max|ref|. Both packages run bf16 activations and return
# bf16 logits, whose ulp is 1/128 of a logit in [1, 2): 0.5% of these
# files' max|logit| of 1.4-1.6. The port's down kernel takes the GLU in
# f32 where JAX's moe_mlp rounds it to bf16 first, and each of the E
# experts adds its own bf16 output: the port sat 0.73-1.01% from JAX on
# three seeds (0.73-0.81% with the GLU unfused), hence twice the dense
# forward's 1e-2 of tests/test_torch_model.py.
JAX_TOL = 2e-2
# the plain reference keeps every activation in f32 (no bf16 rounding of
# the residual, the norms' or the projections' outputs): the JAX package
# sat 1.11-1.62% from it on the same three seeds, the port 1.11-1.41%
REF_TOL = 3e-2


def _file(tmp_path, cfg, seed=3, fmt=GGMLType.Q4_K) -> str:
    path = str(tmp_path / "moe.gguf")
    write_random_llama_gguf(path, cfg, fmt=fmt, seed=seed)
    return path


def _port_logits(path, tokens):
    cfg, params = load_llama(path, "cpu")
    logits, _ = forward(fuse_llama_params(params), cfg,
                        torch.as_tensor(tokens),
                        torch.zeros(1, dtype=torch.int32),
                        init_kv_cache(cfg, 1, cfg.max_seq_len, "cpu"),
                        MMOpts(), span=cfg.max_seq_len)
    return logits.numpy()


def _jax_logits(path, tokens):
    import jax
    import jax.numpy as jnp

    from gguf_tpu.models import MMOpts as JaxMMOpts
    from gguf_tpu.models import forward as jax_forward
    from gguf_tpu.models import fuse_llama_params as jax_fuse
    from gguf_tpu.models import init_kv_cache as jax_init_cache
    from gguf_tpu.models import load_llama as jax_load_llama

    jcfg, jparams = jax_load_llama(path)
    logits, _ = jax.jit(jax_forward, static_argnames=("cfg", "opts",
                                                      "span"))(
        jax_fuse(jparams), jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, jcfg.max_seq_len),
        opts=JaxMMOpts(), span=jcfg.max_seq_len)
    return np.asarray(logits)


def _harness_model(cfg: LlamaConfig):
    """The benchmark's `Model` of a mixtral-architecture file of `cfg`."""
    from perfbench.model import Model

    return Model.from_config("moe", {
        "architecture": "mixtral", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.ffn_dim,
        "num_local_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.n_experts_used,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": False, "recipe": "q4_k_m",
        "max_seq": cfg.max_seq_len, "max_batch": 1})


def _reference_weights(path) -> dict:
    """The file's tensors as the harness hands them to its reference:
    {name: (format, shape, uint8 rows or f32)}."""
    reader = GGUFReader(path)
    try:
        weights = {}
        for name, info in reader.tensors.items():
            fmt = GGMLType(info.ggml_type).name.lower()
            if fmt == "f32":
                view = torch.from_numpy(np.array(reader.load_array(name)))
            else:
                raw = np.array(reader.tensor_bytes(name))
                view = torch.from_numpy(raw).reshape(*info.shape[:-1], -1)
            weights[name] = (fmt, tuple(info.shape), view)
        return weights
    finally:
        reader.close()


def _reference_logits(path, cfg, tokens):
    """perfbench/references/mixtral.py's logits at every position."""
    from perfbench.references import mixtral as ref

    seq = [int(t) for t in tokens[0]]
    with ref._no_tf32():
        rows = ref._served_logits(_harness_model(cfg),
                                  _reference_weights(path),
                                  [(seq[:1], seq[1:] + [0])],
                                  torch.device("cpu"))
    return rows[0].numpy()[None]


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------ (a) k == E ---

def test_smooth_routing_matches_jax_and_the_reference(tmp_path):
    """(a) A 2-layer file at k == E: the port's logits of an 8-token
    prefill against the JAX package's `forward` (its `moe_mlp`) and
    against the benchmark's plain f32 reference."""
    path = _file(tmp_path, SMOOTH)
    tokens = np.random.default_rng(4).integers(0, SMOOTH.vocab_size, (1, 8))
    got = _port_logits(path, tokens)
    jax_ref = _jax_logits(path, tokens)
    plain = _reference_logits(path, SMOOTH, tokens)
    assert got.shape == jax_ref.shape == plain.shape == (1, 8, 128)
    assert np.isfinite(got).all()
    assert _rel(got, jax_ref) <= JAX_TOL
    assert _rel(got, plain) <= REF_TOL


# ------------------------------------------ (b) the top-2 selection ---

def _crafted(n_expert=4, dim=256, ffn=256, seed=0):
    """A routed layer whose router is [I_E | 0] and whose experts are
    random Q8_0 matrices, and rows x whose first E entries are the
    logits: every row's third logit lies at least 1 below its second."""
    from gguf_tpu_torch.gguf import quantize_tensor

    rng = np.random.default_rng(seed)
    logits = np.array([[3.0, 1.0, -2.0, 0.0],
                       [-1.0, 2.5, 0.5, 4.0],
                       [0.5, -0.5, 2.0, -3.0],
                       [1.5, -1.0, 0.25, 2.75]], np.float32)
    x = np.zeros((len(logits), dim), np.float32)
    x[:, :n_expert] = logits
    router = np.zeros((n_expert, dim), np.float32)
    router[:, :n_expert] = np.eye(n_expert)

    def stack(m, k):
        w = rng.standard_normal((n_expert * m, k)).astype(np.float32) * 0.1
        return QuantWeight.from_blocks(
            "q8_0", quantize_tensor(w, GGMLType.Q8_0), (n_expert * m, k),
            "cpu")

    layer = {"gate_inp": torch.from_numpy(router),
             "gate_exps": stack(ffn, dim), "up_exps": stack(ffn, dim),
             "down_exps": stack(dim, ffn)}
    x = torch.from_numpy(x).to(torch.bfloat16)[None]
    return layer, x, logits


def test_top2_selection_and_renormalisation():
    """(b) The routing weights of the crafted rows are the softmax over
    all four logits, kept on the two largest, renormalised to sum 1, and
    zero elsewhere; the FFN's output is the f32 sum of the two experts'
    outputs under those weights, cast to bf16."""
    layer, x, logits = _crafted()
    cfg = dataclasses.replace(SMOOTH, n_experts_used=2)
    w = llama.routing_weights(layer, x.reshape(4, -1), cfg)
    e = np.exp(logits - logits.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)
    top2 = np.argsort(-logits, axis=1)[:, :2]
    want = np.zeros_like(probs)
    for n, (a, b) in enumerate(top2):
        want[n, [a, b]] = probs[n, [a, b]] / probs[n, [a, b]].sum()
    assert (w.numpy() > 0).sum(1).tolist() == [2, 2, 2, 2]
    assert np.array_equal(w.numpy() > 0, want > 0)
    np.testing.assert_allclose(w.numpy(), want, rtol=1e-6, atol=0)
    out = llama.moe_mlp(layer, x, cfg, MMOpts())
    acc = torch.zeros(4, x.shape[-1])
    for j, expert in enumerate(llama.experts(layer)):
        acc += w[:, j:j + 1] * llama.mlp(expert, x, MMOpts())[0].float()
    assert torch.equal(out[0], acc.to(torch.bfloat16))


def test_fused_gate_up_pairs_each_experts_rows():
    """`fuse_llama_params` pairs expert e's gate and up rows at rows
    e*2M..(e+1)*2M of one stack, each expert's slice a view."""
    layer, _, _ = _crafted()
    fused = fuse_llama_params({"layers": [layer]})["layers"][0]
    assert "gate_exps" not in fused and "up_exps" not in fused
    for e, ex in enumerate(llama.experts(fused)):
        gu = ex["gate_up"].dequantize()
        assert torch.equal(gu[:256], layer["gate_exps"].dequantize()
                           [e * 256:(e + 1) * 256])
        assert torch.equal(gu[256:], layer["up_exps"].dequantize()
                           [e * 256:(e + 1) * 256])
        qs = ex["gate_up"].fields["qs"]
        assert qs.data_ptr() == (fused["gate_up_exps"].fields["qs"]
                                 [e * 512].data_ptr())


# ------------------------------------- (c) prefill against decode ---

def test_prefill_equals_decode_steps(tmp_path):
    """(c) At top 2, one 4-token prefill and four 1-token decode steps
    through the INT8 cache give the same logits and the same cache."""
    path = _file(tmp_path, TOP2, seed=5)
    cfg, params = load_llama(path, "cpu")
    params = fuse_llama_params(params)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 4)))
    pos0 = torch.zeros(1, dtype=torch.int32)
    cache_a = init_kv_cache(cfg, 1, 64, "cpu")
    whole, _ = forward(params, cfg, tokens, pos0, cache_a, MMOpts(), span=64)
    cache_b = init_kv_cache(cfg, 1, 64, "cpu")
    steps = [forward(params, cfg, tokens[:, i:i + 1], pos0 + i, cache_b,
                     MMOpts(), span=64)[0] for i in range(4)]
    steps = torch.cat(steps, dim=1)
    assert _rel(steps.numpy(), whole.numpy()) <= 1e-3
    for la, lb in zip(cache_a, cache_b):
        for name in la:
            assert torch.allclose(la[name].float(), lb[name].float(),
                                  atol=1, rtol=1e-2), name


# ---------------------------------------------- (d) generate serves ---

def test_generate_serves_a_top2_model(tmp_path):
    """(d) `LLM.generate` over 5 prompts on 3 slots: every request gets
    its tokens, the prefill's counters (what `moe_mlp` ran, kept per
    chunk key) read k / E of its token use, and the served tokens are the
    plain reference's greedy ones up to rounding."""
    path = _file(tmp_path, TOP2, seed=7)
    llm = LLM(path, max_batch=3, max_seq=256, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, TOP2.vocab_size, n)]
               for n in (3, 9, 17, 30, 60)]
    out = llm.generate(prompts, max_new_tokens=10)
    assert [len(r.token_ids) for r in out] == [10] * 5
    st = out[0].stats
    padded = sum(t * n for t, n in st["prefill_widths"].items())
    assert st["prefill_moe_routed"] == 2 * 2 * sum(map(len, prompts))
    assert st["prefill_expert_rows"] == 4 * 2 * padded
    assert llm.graphs.prefill_moe == {k: (2, 2 * 4 * k[0])
                                      for k in llm.graphs.prefill_keys()}
    from perfbench.references import mixtral as ref

    gaps = np.concatenate(ref.served_gaps(
        _harness_model(TOP2), _reference_weights(path),
        [(p, r.token_ids) for p, r in zip(prompts, out)], "cpu"))
    assert gaps.mean() < 2e-3 and (gaps > 0).mean() < 0.1


def test_dense_model_counts_no_expert_rows(tmp_path):
    """A dense file's `generate` counts no routed pairs and no expert
    rows."""
    path = _file(tmp_path, dataclasses.replace(TOP2, n_experts=0,
                                               n_experts_used=0))
    out = LLM(path, max_batch=2, max_seq=256, device="cpu").generate(
        [[1, 2, 3]], max_new_tokens=3)
    assert out[0].stats["prefill_moe_routed"] == 0
    assert out[0].stats["prefill_expert_rows"] == 0


# ------------------------------------------ (e) the harness's toy ---

def test_harness_toy_loads_in_both_packages():
    """(e) The benchmark's toy Mixtral file (`archs/mixtral.toy`: 2
    layers, 4 experts, top 2, Q4_K_M's formats), made from a seed by its
    own writer, loads in both packages, and their logits agree."""
    from perfbench.harness import load_cell
    from perfbench.model import arch
    from perfbench.weights import Checkpoint, make_bytes

    m = load_cell("mixtral8x7b_q4km.chat").model
    toy = arch(m).toy(m)
    ckpt = Checkpoint(toy, make_bytes(toy, 2**31 + 12345, "cpu"),
                      os.path.join("perfbench", ".cache", "checkpoint"))
    try:
        tokens = np.random.default_rng(9).integers(0, toy.vocab, (1, 12))
        got = _port_logits(ckpt.path, tokens)
        jax_ref = _jax_logits(ckpt.path, tokens)
    finally:
        ckpt.close()
    assert got.shape == jax_ref.shape == (1, 12, toy.vocab)
    assert _rel(got, jax_ref) <= JAX_TOL


# ----------------------------------------------------- loader, writer ---

@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q8_0])
def test_writer_matches_jax_writer(tmp_path, fmt):
    """The port's writer makes an expert file byte-identical to the JAX
    package's with the same seed: router then stacks in each layer."""
    from gguf_tpu.models import LlamaConfig as JaxConfig
    from gguf_tpu.models import write_random_llama_gguf as jax_write

    ours, theirs = str(tmp_path / "a.gguf"), str(tmp_path / "b.gguf")
    write_random_llama_gguf(ours, TOP2, fmt=fmt, seed=11)
    jax_write(theirs, JaxConfig(**dataclasses.asdict(TOP2)), fmt=fmt,
              seed=11)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    reader = GGUFReader(ours)
    try:
        assert reader.tensors["blk.1.ffn_down_exps.weight"].shape == \
            (4, 256, 256)
        assert "blk.0.ffn_gate.weight" not in reader.tensors
    finally:
        reader.close()


def test_loader_takes_each_stack_as_one_weight(tmp_path):
    """A stack loads as one QuantWeight of E*M rows; expert e is a view
    of its rows e*M..(e+1)*M; the router is f32 (E, dim)."""
    cfg, params = load_llama(_file(tmp_path, TOP2), "cpu")
    layer = params["layers"][0]
    assert set(layer) == {"attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                          "gate_inp", "gate_exps", "up_exps", "down_exps"}
    assert layer["gate_inp"].dtype == torch.float32
    assert layer["gate_inp"].shape == (4, 256)
    assert layer["gate_exps"].shape == (4 * 256, 256)
    ex = llama.experts(layer)[2]
    blocks = layer["down_exps"].fields["blocks"]
    assert ex["down"].fields["blocks"].data_ptr() == blocks[512].data_ptr()


@pytest.mark.parametrize("name,message", [
    ("blk.0.ffn_gate.0.weight", "per-expert 2-D tensors"),
    ("blk.0.ffn_gate.weight", "the port's forward does not compute it"),
])
def test_loader_refuses_other_expert_schemas(name, message):
    with pytest.raises(NotImplementedError,
                       match=rf"^tensor {name}: {message}"):
        check_tensors_loaded(["token_embd.weight", name], TOP2)


def test_loader_refuses_an_expert_file_without_its_stacks():
    names = [f"blk.{i}.{t}.weight" for i in range(2)
             for t in ("attn_norm", "ffn_norm", "attn_q", "attn_k",
                       "attn_v", "attn_output", "ffn_gate_inp",
                       "ffn_gate_exps", "ffn_up_exps")]
    with pytest.raises(NotImplementedError,
                       match=r"^tensor blk.0.ffn_down_exps.weight: missing"):
        check_tensors_loaded(names, TOP2)


@pytest.mark.parametrize("cfg,field", [
    (dataclasses.replace(TOP2, n_experts_used=5), "n_experts"),
    (dataclasses.replace(TOP2, expert_ffn_dim=128), "expert_ffn_dim"),
    (dataclasses.replace(TOP2, n_shared_experts=1), "n_shared_experts"),
    (dataclasses.replace(TOP2, routed_scale=2.5), "routed_scale"),
    (dataclasses.replace(TOP2, moe_renorm=False), "moe_renorm"),
    (dataclasses.replace(TOP2, moe_gating="sigmoid"), "moe_gating"),
    (dataclasses.replace(TOP2, leading_dense_layers=1),
     "leading_dense_layers"),
])
def test_config_check_takes_the_mixtral_form_only(cfg, field):
    from gguf_tpu_torch.models.loader import check_forward_computes

    with pytest.raises(NotImplementedError, match=rf"^{field} = "):
        check_forward_computes(cfg)
    check_forward_computes(dataclasses.replace(TOP2, expert_ffn_dim=256))


# --------------------------------------------------------- on the card ---

@pytest.fixture(scope="module")
def card_mixtral():
    """`LLM` over two layers of Mixtral-8x7B's widths in its Q4_K_M
    formats (layer 0's down Q4_K, layer 1's Q6_K), from seeded bytes."""
    if not torch.cuda.is_available():
        pytest.skip("replays CUDA graphs on a CUDA device")
    from perfbench.harness import load_cell
    from perfbench.weights import Checkpoint, make_bytes

    m = dataclasses.replace(load_cell("mixtral8x7b_q4km.chat").model,
                            layers=2, max_seq=2048)
    ckpt = Checkpoint(m, make_bytes(m, 2**31 + 17, "cuda"),
                      os.path.join("perfbench", ".cache", "checkpoint"))
    torch.cuda.empty_cache()
    try:
        llm = LLM(ckpt.path, max_batch=16, max_seq=2048, device="cuda")
    finally:
        ckpt.close()
    return llm


@pytest.mark.card
def test_no_sync_inside_a_mixtral_chunk_on_the_card(card_mixtral,
                                                    monkeypatch):
    """Every forward (eager warm-ups and captures) under torch's sync
    debug mode "error"; then chip_smoke's count: a replayed prefill
    chunk makes no sync, and a `generate` call's syncs are its prompts'
    first-token reads and its decode chunks' reads."""
    import chip_smoke
    from gguf_tpu_torch.engine import decode_graph, engine

    def strict(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    monkeypatch.setattr(decode_graph, "forward", strict(forward))
    monkeypatch.setattr(engine, "forward", strict(forward))
    chip_smoke.sync_check(card_mixtral, seed=3)


@pytest.mark.card
@pytest.mark.parametrize("t", [8, 16, 64, 512])
def test_replayed_mixtral_prefill_equals_eager_on_the_card(card_mixtral, t):
    """Slot 2 at start 700: the eager chunk, then from the same cache the
    chunk that captures its graph and the one that replays it, each
    bit-equal to the eager one in its logits row and every cache byte,
    and each counting what its capture ran: 2 expert layers, 8 experts
    over t rows in each."""
    llm = card_mixtral
    toks = np.random.default_rng(t).integers(
        0, llm.cfg.vocab_size, (1, t)).astype(np.int32)
    start, slot = 700, 2
    span = llm._span_bucket(start + t)
    saved = [{n: c.clone() for n, c in layer.items()} for layer in llm.cache]
    ref = llm._prefill_eager(toks, slot, start, t - 1, span).clone()
    ref_cache = [{n: c.clone() for n, c in layer.items()}
                 for layer in llm.cache]
    for call in ("capture", "replay"):
        for layer, old in zip(llm.cache, saved):
            for n, c in layer.items():
                c.copy_(old[n])
        got = llm._prefill(toks, slot, start, t - 1, span).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, ref), call
        assert llm.graphs.last_prefill_moe == (2, 2 * 8 * t), call
        assert all(torch.equal(c, r[n]) for layer, r in
                   zip(llm.cache, ref_cache) for n, c in layer.items()), call
    assert torch.isfinite(ref).all()


@pytest.mark.card
def test_replayed_mixtral_decode_equals_eager_on_the_card(card_mixtral):
    """An 8-step decode chunk of 16 slots at mixed positions: the
    replayed graph's ids and cache equal the eager loop's."""
    from gguf_tpu_torch.engine import SamplerConfig

    llm = card_mixtral
    rng = np.random.default_rng(12)
    tokens = torch.as_tensor(rng.integers(0, llm.cfg.vocab_size, 16),
                             device="cuda")
    pos = torch.as_tensor(rng.integers(0, 1500, 16), device="cuda")
    saved = [{n: c.clone() for n, c in layer.items()} for layer in llm.cache]
    eager = llm._decode_eager(tokens, pos, SamplerConfig(), 8, 2048,
                              llm.generator).cpu().numpy()
    eager_cache = [{n: c.clone() for n, c in layer.items()}
                   for layer in llm.cache]
    for _ in range(2):              # the capture, then a replay
        for layer, old in zip(llm.cache, saved):
            for n, c in layer.items():
                c.copy_(old[n])
        chunk = llm._decode(tokens.cpu().numpy(), pos.cpu().numpy(),
                            SamplerConfig(), 8, 2048, llm.generator)
        assert np.array_equal(chunk.ids, eager) and chunk.finite
        assert all(torch.equal(c, r[n]) for layer, r in
                   zip(llm.cache, eager_cache) for n, c in layer.items())
