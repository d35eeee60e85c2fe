"""Checkpoints of the low-bit formats through the port's writer, loader and
Llama forward, held against the JAX package: TinyLlama-shaped (at 2
layers and narrow widths) in llama.cpp's Q2_K mix (`chip_smoke.py`'s
`q2k_mix_type`, the recipe the card serves), and uniform Q3_K and IQ4_XS.
The writer is byte-identical to the JAX one at Q2_K, Q3_K, IQ4_NL and
IQ4_XS; the loaded tensors equal the JAX params carried across by
`params_from_jax`; each package fuses the mix's layers the same way; and a
2-layer forward on the carried params is within the tolerances of
tests/test_torch_model.py, with bf16 activations and under act_quant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import q2k_mix_type, write_q2k_mix
from gguf_tpu.gguf import GGMLType as JaxGGMLType
from gguf_tpu.models import LlamaConfig as JaxLlamaConfig
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import fuse_llama_params as jax_fuse
from gguf_tpu.models import init_kv_cache as jax_init_cache
from gguf_tpu.models import load_llama as jax_load_llama
from gguf_tpu.models import write_random_llama_gguf as jax_write
from gguf_tpu.quant.layouts import QuantTensor, from_soa
from gguf_tpu_torch.models import (GGMLType, LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, params_from_jax,
                                   write_random_llama_gguf)
from gguf_tpu_torch.quant import QuantWeight

# 4 query heads over 1 KV head of 64: n_gqa = 4, so the mix keeps attn_v
# at Q4_K as it does for TinyLlama (32 over 4)
SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=1,
             ffn_dim=512, max_seq_len=256)
CFG = LlamaConfig(**SHAPE)
S = 256
TOL = 1e-2            # tests/test_torch_model.py: bf16 residual stream
TOL_ACT_QUANT = 3e-2  # the same file's act_quant bound
CHECKPOINTS = ("q2k_mix", "Q3_K", "IQ4_XS")


def _bound(ref: np.ndarray, tol: float) -> float:
    """tol * max|ref|, but never under two bf16 ulps of max|ref| (as in
    tests/test_torch_block32_model.py: at logits near 2, 1e-2 of the peak
    is one to two ulps)."""
    peak = float(np.max(np.abs(ref)))
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    return max(tol * peak, 2 * ulp)


def _np_params(params):
    """Reference params with QuantTensors as (fmt, GGUF bytes, (M, K))."""
    def conv(v):
        if isinstance(v, QuantTensor):
            return (v.fmt, from_soa(v), v.shape)
        return np.asarray(v)

    return {k: ([{n: conv(w) for n, w in layer.items()} for layer in v]
                if k == "layers" else conv(v)) for k, v in params.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_kquant_low_model")
    out = {}
    for i, tag in enumerate(CHECKPOINTS):
        path = str(root / f"tiny_{tag.lower()}.gguf")
        if tag == "q2k_mix":
            write_q2k_mix(path, CFG, seed=30 + i)
        else:
            write_random_llama_gguf(path, CFG, fmt=GGMLType[tag], seed=30 + i)
        out[tag] = path
    return out


@pytest.fixture(scope="module")
def jax_fwd():
    return jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))


@pytest.mark.parametrize("fmt", ["Q2_K", "Q3_K", "IQ4_NL", "IQ4_XS"])
def test_writer_byte_identical_to_jax(tmp_path, fmt):
    """Every matrix in `fmt`, the head included (the JAX writer's recipe
    outside Q4_K to Q6_K)."""
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_random_llama_gguf(a, CFG, fmt=GGMLType[fmt], seed=7)
    jax_write(b, JaxLlamaConfig(**SHAPE), fmt=JaxGGMLType[fmt], seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_q2k_mix_recipe():
    """llama.cpp's Q2_K mix: attn_v Q4_K at n_gqa >= 4 (Q3_K below),
    attn_output and ffn_down Q3_K, the head Q6_K, the rest Q2_K."""
    t = {n: q2k_mix_type(f"blk.0.{n}.weight", CFG)
         for n in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                   "ffn_up", "ffn_down")}
    assert t == {"attn_q": GGMLType.Q2_K, "attn_k": GGMLType.Q2_K,
                 "attn_v": GGMLType.Q4_K, "attn_output": GGMLType.Q3_K,
                 "ffn_gate": GGMLType.Q2_K, "ffn_up": GGMLType.Q2_K,
                 "ffn_down": GGMLType.Q3_K}
    assert q2k_mix_type("output.weight", CFG) == GGMLType.Q6_K
    assert q2k_mix_type("token_embd.weight", CFG) == GGMLType.Q2_K
    mha = LlamaConfig(**{**SHAPE, "n_kv_heads": 2})
    assert q2k_mix_type("blk.3.attn_v.weight", mha) == GGMLType.Q3_K


def _same(got, ref, where):
    if isinstance(ref, QuantWeight):
        assert isinstance(got, QuantWeight), where
        assert (got.fmt, got.shape) == (ref.fmt, ref.shape), where
        assert got.fields.keys() == ref.fields.keys(), where
        for name in ref.fields:
            assert torch.equal(got.fields[name], ref.fields[name]), where
    else:
        assert got.dtype == ref.dtype and torch.equal(got, ref), where


@pytest.mark.parametrize("tag", CHECKPOINTS)
def test_loader_matches_converted_jax_params(checkpoints, tag):
    """`params_from_jax` carries the JAX params across (stripping the TPU
    padding) to exactly what `load_llama` reads, format by format."""
    jcfg, jparams = jax_load_llama(checkpoints[tag])
    cfg, params = load_llama(checkpoints[tag], "cpu")
    conv = params_from_jax(_np_params(jparams), cfg, "cpu")
    assert conv.keys() == params.keys()
    for key in ("token_embd", "output", "output_norm"):
        _same(conv[key], params[key], key)
    for i, (lc, lp) in enumerate(zip(conv["layers"], params["layers"])):
        assert lc.keys() == lp.keys()
        for key in lp:
            _same(lc[key], lp[key], (i, key))
    fmts = {key: params["layers"][0][key].fmt
            for key in ("wq", "wv", "wo", "gate", "down")}
    if tag == "q2k_mix":
        assert fmts == {"wq": "q2_k", "wv": "q4_k", "wo": "q3_k",
                        "gate": "q2_k", "down": "q3_k"}
        assert (params["token_embd"].fmt, params["output"].fmt) == \
            ("q2_k", "q6_k")
    else:
        assert set(fmts.values()) == {tag.lower()}
        assert params["output"].fmt == tag.lower()


@pytest.mark.parametrize("tag", CHECKPOINTS)
def test_fusion_matches_jax(checkpoints, tag):
    """Fusion is per format, as in the reference: the mix keeps wq, wk
    (Q2_K) and wv (Q4_K) apart and fuses gate_up (both Q2_K); a uniform
    file fuses wqkv and gate_up."""
    _, jparams = jax_load_llama(checkpoints[tag])
    _, params = load_llama(checkpoints[tag], "cpu")
    fused, jfused = fuse_llama_params(params), jax_fuse(jparams)
    for lp, lj in zip(fused["layers"], jfused["layers"]):
        assert set(lp) == set(lj)
        assert "gate_up" in lp
        assert ("wqkv" in lp) == (tag != "q2k_mix")


OPTS = {"bf16": (JaxMMOpts(), MMOpts(), TOL, 8),
        "act_quant": (JaxMMOpts(act_quant=True, precision="high"),
                      MMOpts(act_quant=True, precision="high"),
                      TOL_ACT_QUANT, 40)}


@pytest.mark.parametrize("mode", ["bf16", "act_quant"])
@pytest.mark.parametrize("tag", CHECKPOINTS)
def test_forward_on_carried_params_matches_jax(checkpoints, jax_fwd, tag,
                                               mode):
    """2 layers on the params `params_from_jax` carries across, fused as
    each package fuses them: bf16 activations ("fast") at t = 8 and
    act_quant ("high": K6, then K12, K13 or K14 at every width, and K6
    then K1 for the mix's Q4_K wv at this width) at t = 40."""
    jopts, opts, tol, t = OPTS[mode]
    jcfg, jparams = jax_load_llama(checkpoints[tag])
    params = fuse_llama_params(
        params_from_jax(_np_params(jparams), CFG, "cpu"))
    assert isinstance(params["token_embd"], torch.Tensor)   # dequantized
    tokens = np.random.default_rng(t).integers(0, CFG.vocab_size, (1, t))
    ref, _ = jax_fwd(jax_fuse(jparams), jcfg, jnp.asarray(tokens, jnp.int32),
                     jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, S),
                     opts=jopts, span=128)
    got, _ = forward(params, CFG, torch.from_numpy(tokens),
                     torch.zeros(1, dtype=torch.int32),
                     init_kv_cache(CFG, 1, S, "cpu"), opts, span=128)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.max(np.abs(got - ref))
    assert err <= _bound(ref, tol), (err, np.max(np.abs(ref)))
