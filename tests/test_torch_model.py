"""The port's checkpoint writer, loader and Llama forward held against the
JAX package: byte-identical files, identical loaded tensors, and logits
within tolerance for prefill chunks and continuous-batching decode steps,
for Q4_K_M and Q5_K_M checkpoints, with bf16 and Q8_1 (act_quant)
activations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import fuse_llama_params as jax_fuse
from gguf_tpu.models import init_kv_cache as jax_init_cache
from gguf_tpu.models import load_llama as jax_load_llama
from gguf_tpu.models import write_random_llama_gguf as jax_write
from gguf_tpu.models import LlamaConfig as JaxLlamaConfig
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu.gguf import GGMLType
from gguf_tpu.quant.layouts import QuantTensor, from_soa
from gguf_tpu_torch.models import (LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, params_from_jax,
                                   write_random_llama_gguf)
from gguf_tpu_torch.quant import QuantWeight

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=512, max_seq_len=256)
CFG = LlamaConfig(**SHAPE)
S = 256
# logits: the bf16 residual stream carries last-ulp differences (silu,
# cos, sin, summation order) through both layers
TOL = 1e-2
# under act_quant a last-ulp difference in a projection's input can move a
# Q8_1 code by one whole quantum (1/127 of its block's max), so the same
# upstream differences land as 3-4 bf16 ulps of the largest logit (one
# ulp is 0.4-0.8% of it) instead of 1-2
TOL_ACT_QUANT = 3e-2


def jax_params_as_numpy(params):
    """Reference params with QuantTensors as (fmt, GGUF bytes, (M, K))."""
    def conv(v):
        if isinstance(v, QuantTensor):
            return (v.fmt, from_soa(v), v.shape)
        return np.asarray(v)

    return {k: ([{n: conv(w) for n, w in layer.items()} for layer in v]
                if k == "layers" else conv(v)) for k, v in params.items()}


def _load_both(path):
    jcfg, jparams = jax_load_llama(path)
    cfg, params = load_llama(path, "cpu")
    return path, (jcfg, jax_fuse(jparams), jparams), (cfg, params)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_model") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, seed=1)
    return _load_both(path)


@pytest.fixture(scope="module")
def models_q5(tmp_path_factory):
    """Q5_K_M: Q5_K projections and embedding, Q6_K head."""
    path = str(tmp_path_factory.mktemp("torch_model_q5") / "tiny_q5.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q5_K, seed=2)
    return _load_both(path)


@pytest.fixture(scope="module")
def jax_fwd():
    return jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))


def test_writer_byte_identical_to_jax(tmp_path):
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_random_llama_gguf(a, CFG, seed=7)
    jax_write(b, JaxLlamaConfig(**SHAPE), seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_writer_byte_identical_to_jax_q5_k_m(tmp_path):
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_random_llama_gguf(a, CFG, fmt=GGMLType.Q5_K, seed=7)
    jax_write(b, JaxLlamaConfig(**SHAPE), fmt=GGMLType.Q5_K, seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_writer_byte_identical_to_jax_mha_hd128(tmp_path):
    """Llama-2-7B's attention geometry: 32 heads and 32 KV heads of 128
    (dim cut to 512 through head_dim_override, so the file stays small)."""
    shape = dict(vocab_size=256, dim=512, n_layers=1, n_heads=32,
                 n_kv_heads=32, ffn_dim=256, max_seq_len=4096,
                 head_dim_override=128)
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_random_llama_gguf(a, LlamaConfig(**shape), seed=7)
    jax_write(b, JaxLlamaConfig(**shape), seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _assert_same(got, ref, where):
    if isinstance(ref, QuantWeight):
        assert isinstance(got, QuantWeight), where
        assert (got.fmt, got.shape) == (ref.fmt, ref.shape), where
        for name in ref.fields:
            assert torch.equal(got.fields[name], ref.fields[name]), where
    else:
        assert got.dtype == ref.dtype and torch.equal(got, ref), where


def test_loader_matches_converted_jax_params(models):
    _check_converted(models, "q4_k")


def test_loader_matches_converted_jax_params_q5_k_m(models_q5):
    _check_converted(models_q5, "q5_k")


def _check_converted(models, body):
    _, (_, _, jparams), (cfg, params) = models
    conv = params_from_jax(jax_params_as_numpy(jparams), cfg, "cpu")
    assert conv.keys() == params.keys()
    for key in ("token_embd", "output", "output_norm"):
        _assert_same(conv[key], params[key], key)
    assert params["output"].fmt == "q6_k"
    assert params["token_embd"].fmt == params["layers"][0]["down"].fmt == body
    for i, (lc, lp) in enumerate(zip(conv["layers"], params["layers"])):
        assert lc.keys() == lp.keys()
        for key in lp:
            _assert_same(lc[key], lp[key], (i, key))


def _assert_logits_close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("t", [8, 16, 40])
def test_prefill_logits_match_jax(models, jax_fwd, t):
    _, (jcfg, jfused, _), (cfg, params) = models
    tokens = np.random.default_rng(t).integers(0, CFG.vocab_size, (1, t))
    ref, _ = jax_fwd(jfused, jcfg, jnp.asarray(tokens, jnp.int32),
                     jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, S),
                     opts=JaxMMOpts(), span=128)
    got, _ = forward(fuse_llama_params(params), cfg,
                     torch.from_numpy(tokens), torch.zeros(1, dtype=torch.int32),
                     init_kv_cache(cfg, 1, S, "cpu"), MMOpts(), span=128)
    _assert_logits_close(got, ref)


def test_decode_steps_with_per_slot_positions_match_jax(models, jax_fwd):
    """Batch 4: a joint 40-token prefill, then 4 decode steps with the slots
    at different depths (continuous batching)."""
    _, (jcfg, jfused, _), (cfg, params) = models
    fused = fuse_llama_params(params)
    rng = np.random.default_rng(11)
    pre = rng.integers(0, CFG.vocab_size, (4, 40))
    jcache = jax_init_cache(jcfg, 4, S)
    cache = init_kv_cache(cfg, 4, S, "cpu")
    _, jcache = jax_fwd(jfused, jcfg, jnp.asarray(pre, jnp.int32),
                        jnp.zeros(4, jnp.int32), jcache, opts=JaxMMOpts(),
                        span=128)
    forward(fused, cfg, torch.from_numpy(pre), torch.zeros(4, dtype=torch.int32),
            cache, MMOpts(), span=128)
    pos = np.array([40, 31, 17, 38], np.int32)
    for _ in range(4):
        tok = rng.integers(0, CFG.vocab_size, (4, 1))
        ref, jcache = jax_fwd(jfused, jcfg, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos), jcache, opts=JaxMMOpts(),
                              span=128)
        got, cache = forward(fused, cfg, torch.from_numpy(tok),
                             torch.from_numpy(pos), cache, MMOpts(), span=128)
        _assert_logits_close(got, ref)
        pos = pos + 1


def test_fused_params_keep_logits(models):
    """QKV and gate/up concatenation is a pure relayout: with the GLU
    fusion off the fused and unfused params give identical logits."""
    _, _, (cfg, params) = models
    fused = fuse_llama_params(params)
    assert "wqkv" in fused["layers"][0] and "gate_up" in fused["layers"][0]
    assert isinstance(fused["token_embd"], torch.Tensor)   # dequantized
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 5)))
    pos = torch.zeros(2, dtype=torch.int32)
    opts = MMOpts(fuse_glu=False)
    a, _ = forward(params, cfg, tokens, pos, init_kv_cache(cfg, 2, S, "cpu"),
                   opts)
    b, _ = forward(fused, cfg, tokens, pos, init_kv_cache(cfg, 2, S, "cpu"),
                   opts)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


OPTS = {"bf16": (JaxMMOpts(), MMOpts(), TOL),
        "act_quant": (JaxMMOpts(act_quant=True, precision="high"),
                      MMOpts(act_quant=True, precision="high"), TOL_ACT_QUANT)}


@pytest.mark.parametrize("which", ["models", "models_q5"])
@pytest.mark.parametrize("mode", ["bf16", "act_quant"])
@pytest.mark.parametrize("t", [8, 40])
def test_prefill_logits_match_jax_per_format_and_mode(request, jax_fwd,
                                                      which, mode, t):
    """Q4_K_M and Q5_K_M, bf16 activations and act_quant + "high": at
    t = 8 every projection takes the integer route (K5 + K7, n <= 16), at
    t = 40 the fake-quant route (K6 + the float kernel)."""
    _, (jcfg, jfused, _), (cfg, params) = request.getfixturevalue(which)
    jopts, opts, tol = OPTS[mode]
    tokens = np.random.default_rng(t + 1).integers(0, CFG.vocab_size, (1, t))
    ref, _ = jax_fwd(jfused, jcfg, jnp.asarray(tokens, jnp.int32),
                     jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, S),
                     opts=jopts, span=128)
    got, _ = forward(fuse_llama_params(params), cfg,
                     torch.from_numpy(tokens), torch.zeros(1, dtype=torch.int32),
                     init_kv_cache(cfg, 1, S, "cpu"), opts, span=128)
    _assert_logits_close(got, ref, tol)


@pytest.mark.parametrize("which", ["models", "models_q5"])
def test_act_quant_decode_steps_match_jax(request, jax_fwd, which):
    """Batch 3 under act_quant + "high": a joint 24-token prefill (n = 72,
    fake-quant route), then 3 decode steps at different depths (n = 3,
    integer route)."""
    _, (jcfg, jfused, _), (cfg, params) = request.getfixturevalue(which)
    jopts, opts, tol = OPTS["act_quant"]
    fused = fuse_llama_params(params)
    rng = np.random.default_rng(5)
    pre = rng.integers(0, CFG.vocab_size, (3, 24))
    jcache = jax_init_cache(jcfg, 3, S)
    cache = init_kv_cache(cfg, 3, S, "cpu")
    _, jcache = jax_fwd(jfused, jcfg, jnp.asarray(pre, jnp.int32),
                        jnp.zeros(3, jnp.int32), jcache, opts=jopts, span=128)
    forward(fused, cfg, torch.from_numpy(pre), torch.zeros(3, dtype=torch.int32),
            cache, opts, span=128)
    pos = np.array([24, 19, 11], np.int32)
    for _ in range(3):
        tok = rng.integers(0, CFG.vocab_size, (3, 1))
        ref, jcache = jax_fwd(jfused, jcfg, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos), jcache, opts=jopts, span=128)
        got, cache = forward(fused, cfg, torch.from_numpy(tok),
                             torch.from_numpy(pos), cache, opts, span=128)
        _assert_logits_close(got, ref, tol)
        pos = pos + 1
