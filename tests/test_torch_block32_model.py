"""Checkpoints of the 32-element-block formats (Q8_0, Q4_0, Q4_1, Q5_0,
Q5_1: every matrix in the format, head and embedding included) through
the port's writer, loader and Llama forward, held against the JAX
package: byte-identical files, the loaded tensors equal to the JAX
params carried across by `params_from_jax`, and a 2-layer forward on
those carried params within the tolerances of tests/test_torch_model.py,
with bf16 activations and under act_quant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=512, max_seq_len=256)
CFG = LlamaConfig(**SHAPE)
FORMATS = ("Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1")
S = 256
TOL = 1e-2            # tests/test_torch_model.py: bf16 residual stream
TOL_ACT_QUANT = 3e-2  # the same file's act_quant bound


def _bound(ref: np.ndarray, tol: float) -> float:
    """tol * max|ref|, but never under two bf16 ulps of max|ref|: the
    logits are bf16, and these checkpoints' logits peak at 1.5-2.1, where
    1e-2 of the peak (0.015-0.021) is one to two ulps (0.0078 below 2,
    0.0156 above), so one last-ulp difference carried through 2 layers
    would otherwise decide the test."""
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
    root = tmp_path_factory.mktemp("torch_block32_model")
    out = {}
    for i, fmt in enumerate(FORMATS):
        path = str(root / f"tiny_{fmt.lower()}.gguf")
        write_random_llama_gguf(path, CFG, fmt=GGMLType[fmt], seed=20 + i)
        out[fmt] = path
    return out


@pytest.fixture(scope="module")
def jax_fwd():
    return jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_byte_identical_to_jax(tmp_path, fmt):
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_random_llama_gguf(a, CFG, fmt=GGMLType[fmt], seed=7)
    jax_write(b, JaxLlamaConfig(**SHAPE), fmt=JaxGGMLType[fmt], seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _same(got, ref, where):
    if isinstance(ref, QuantWeight):
        assert isinstance(got, QuantWeight), where
        assert (got.fmt, got.shape) == (ref.fmt, ref.shape), where
        assert got.fields.keys() == ref.fields.keys(), where
        for name in ref.fields:
            assert torch.equal(got.fields[name], ref.fields[name]), where
    else:
        assert got.dtype == ref.dtype and torch.equal(got, ref), where


@pytest.mark.parametrize("fmt", FORMATS)
def test_loader_matches_converted_jax_params(checkpoints, fmt):
    """`params_from_jax` carries the JAX params across (un-planing Q8_0,
    stripping the TPU padding) to exactly what `load_llama` reads."""
    jcfg, jparams = jax_load_llama(checkpoints[fmt])
    cfg, params = load_llama(checkpoints[fmt], "cpu")
    conv = params_from_jax(_np_params(jparams), cfg, "cpu")
    assert conv.keys() == params.keys()
    for key in ("token_embd", "output", "output_norm"):
        _same(conv[key], params[key], key)
    assert params["output"].fmt == params["token_embd"].fmt == fmt.lower()
    for i, (lc, lp) in enumerate(zip(conv["layers"], params["layers"])):
        assert lc.keys() == lp.keys()
        for key in lp:
            _same(lc[key], lp[key], (i, key))


OPTS = {"bf16": (JaxMMOpts(), MMOpts(), TOL, 8),
        "act_quant": (JaxMMOpts(act_quant=True, precision="high"),
                      MMOpts(act_quant=True, precision="high"),
                      TOL_ACT_QUANT, 40)}


@pytest.mark.parametrize("mode", ["bf16", "act_quant"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_forward_on_carried_params_matches_jax(checkpoints, jax_fwd, fmt,
                                               mode):
    """2 layers on the params `params_from_jax` carries across, fused as
    each package fuses them: bf16 activations ("fast") at t = 8 and
    act_quant ("high": K6, then K10 or K11 at every width) at t = 40."""
    jopts, opts, tol, t = OPTS[mode]
    jcfg, jparams = jax_load_llama(checkpoints[fmt])
    params = fuse_llama_params(
        params_from_jax(_np_params(jparams), CFG, "cpu"))
    assert "wqkv" in params["layers"][0] and "gate_up" in params["layers"][0]
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
