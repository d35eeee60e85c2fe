"""The port's INT8 KV-cache insert (K3) and decode attention (K4), plain
PyTorch versions, held against the JAX package's Pallas kernels
(`kv_cache_insert`, `decode_attention`, `decode_attention_update`) run in
interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gguf_tpu.models.llama import _quantize_kv as jax_quantize_kv
from gguf_tpu.ops.attention import decode_attention as jax_attend
from gguf_tpu.ops.attention import decode_attention_update as jax_update
from gguf_tpu.ops.attention import kv_cache_insert as jax_insert
from gguf_tpu_torch.ops.attention import (decode_attention,
                                          decode_attention_update,
                                          kv_cache_insert, quantize_kv)

B, H, KVH, HD, S, SPAN = 3, 4, 2, 64, 256, 128
# live slots keep pos + t <= span; the last slot is inactive (pos = S)
POS = np.array([7, 100, S], np.int32)
# outputs: f32 softmax and bf16 operands summed in another order
TOL = 1e-3


def _state(t, seed):
    rng = np.random.default_rng(seed)
    cache = {
        "k": rng.integers(-127, 128, (B, KVH, S, HD)).astype(np.int8),
        "v": rng.integers(-127, 128, (B, KVH, S, HD)).astype(np.int8),
        "k_scale": rng.uniform(0.001, 0.02, (B, KVH, S)).astype(np.float32),
        "v_scale": rng.uniform(0.001, 0.02, (B, KVH, S)).astype(np.float32),
    }
    q = rng.standard_normal((B, H, t, HD)).astype(np.float32)
    kn = (rng.standard_normal((B, KVH, t, HD)) * 2).astype(np.float32)
    vn = rng.standard_normal((B, KVH, t, HD)).astype(np.float32)
    kn[0, 0, 0] = 0.0          # an all-zero row quantizes with scale 0
    return q, kn, vn, cache


def _torch_cache(cache):
    return [torch.from_numpy(cache[n].copy())
            for n in ("k", "k_scale", "v", "v_scale")]


def _jax_cache(cache):
    return [jnp.asarray(cache[n]) for n in ("k", "k_scale", "v", "v_scale")]


def _assert_cache_equal(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _assert_close(got, ref):
    ref = np.asarray(ref)
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= TOL * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("t", [1, 8, 16])
def test_insert_codes_and_scales_exact(t):
    _, kn, vn, cache = _state(t, seed=t)
    ref = jax_insert(jnp.asarray(kn), jnp.asarray(vn), *_jax_cache(cache),
                     jnp.asarray(POS), t=t)
    got = _torch_cache(cache)
    out = kv_cache_insert(torch.from_numpy(kn), torch.from_numpy(vn), *got,
                          torch.from_numpy(POS))
    assert all(o is g for o, g in zip(out, got))       # in place
    _assert_cache_equal(got, ref)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("t", [1, 8, 16])
def test_attend_matches_jax(t, precision):
    q, _, _, cache = _state(t, seed=10 + t)
    ref = jax_attend(jnp.asarray(q), *_jax_cache(cache), jnp.asarray(POS),
                     t=t, precision=precision, span=SPAN)
    got = decode_attention(torch.from_numpy(q), *_torch_cache(cache),
                           torch.from_numpy(POS), t=t, precision=precision,
                           span=SPAN)
    assert got.shape == (B, H, t, HD) and got.dtype == torch.float32
    _assert_close(got, ref)


@pytest.mark.parametrize("window,softcap", [(32, 0.0), (0, 2.0)])
@pytest.mark.parametrize("t", [1, 8])
def test_attend_window_and_softcap_match_jax(t, window, softcap):
    """Sliding window drops keys older than `window`; softcap applies
    cap * tanh(score / cap) before the mask (small cap: it saturates)."""
    q, _, _, cache = _state(t, seed=30 + t)
    kw = dict(t=t, precision="fast", span=SPAN, window=window,
              softcap=softcap)
    ref = jax_attend(jnp.asarray(q), *_jax_cache(cache), jnp.asarray(POS),
                     **kw)
    got = decode_attention(torch.from_numpy(q), *_torch_cache(cache),
                           torch.from_numpy(POS), **kw)
    # the inactive slot (pos = S) has no key inside the window: its row is
    # fully masked and its discarded output undefined (the reference's
    # t = 1 form spreads it over every kv head's rows)
    _assert_close(got[:-1], np.asarray(ref)[:-1])


@pytest.mark.parametrize("t", [1, 8, 16])
def test_insert_then_attend_matches_jax(t):
    """At t = 1 the reference takes its fused insert+attend kernel."""
    q, kn, vn, cache = _state(t, seed=20 + t)
    ref_out, *ref_cache = jax_update(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *_jax_cache(cache),
        jnp.asarray(POS), t=t, precision="fast", span=SPAN)
    got_cache = _torch_cache(cache)
    out, *new_cache = decode_attention_update(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        *got_cache, torch.from_numpy(POS), t=t, precision="fast", span=SPAN)
    _assert_cache_equal(new_cache, ref_cache)
    _assert_close(out, ref_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_compiled_reference(dtype):
    """The t > 16 prefill arm quantizes bf16 rows, the inserts f32 rows;
    both match the reference's _quantize_kv as jit compiles it."""
    x = np.random.default_rng(3).standard_normal((2, 2, 24, HD)).astype(
        np.float32)
    qj, sj = jax.jit(jax_quantize_kv)(jnp.asarray(x, getattr(jnp, dtype)))
    qt, st = quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_out_of_range_positions_write_nothing():
    _, kn, vn, cache = _state(4, seed=5)
    got = _torch_cache(cache)
    before = [c.clone() for c in got]
    kv_cache_insert(torch.from_numpy(kn), torch.from_numpy(vn), *got,
                    torch.tensor([S, S + 3, -8], dtype=torch.int32))
    for g, b in zip(got, before):
        assert torch.equal(g, b)
