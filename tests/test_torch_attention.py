"""The port's INT8 KV-cache insert (K3), decode attention (K4) and tiled
flash-decoding (K9), plain PyTorch versions, held against the JAX
package's Pallas kernels (`kv_cache_insert`, `decode_attention`,
`decode_attention_tiled`, `decode_attention_update`) run in interpret mode
on the CPU, and the route each takes past the single-tile envelope."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gguf_tpu.models.llama import _quantize_kv as jax_quantize_kv
from gguf_tpu.ops.attention import PALLAS_ATTN_MAX_ELEMS as JAX_MAX_ELEMS
from gguf_tpu.ops.attention import decode_attention as jax_attend
from gguf_tpu.ops.attention import decode_attention_tiled as jax_tiled
from gguf_tpu.ops.attention import decode_attention_update as jax_update
from gguf_tpu.ops.attention import kv_cache_insert as jax_insert
from gguf_tpu_torch.ops import attention as port_attention
from gguf_tpu_torch.ops.attention import (PALLAS_ATTN_MAX_ELEMS,
                                          decode_attention,
                                          decode_attention_tiled,
                                          decode_attention_tiled_plain,
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


# ------------------------------------------------- K9: tiled flash-decoding ---

# the tiled plain version follows the reference's tile order and rounding
# points; what is left is f32 summation order (and, under "fast", a rare
# bf16 rounding of p * v_scale flipped by it)
TILED_TOL = {"high": 1e-5, "fast": 1e-4}
# positions every tiled case covers: the first row, both sides of a tile
# edge, the last row and an inactive slot (pos = S: every column live)
EDGE_POS = (0, 255, 256, -1, None)


def _tiled_inputs(b, h, kvh, s, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    cache = {
        "k": rng.integers(-127, 128, (b, kvh, s, hd)).astype(np.int8),
        "v": rng.integers(-127, 128, (b, kvh, s, hd)).astype(np.int8),
        "k_scale": rng.uniform(0.001, 0.02, (b, kvh, s)).astype(np.float32),
        "v_scale": rng.uniform(0.001, 0.02, (b, kvh, s)).astype(np.float32),
    }
    return q, cache


def _edge_batches(b, s, rng):
    """Position vectors of batch b that together hold every EDGE_POS."""
    want = [s - 1 if p == -1 else s if p is None else p for p in EDGE_POS]
    out = []
    for i in range(0, len(want), b):
        chunk = want[i:i + b]
        chunk += list(rng.integers(0, s, b - len(chunk)))
        out.append(np.array(chunk, np.int32))
    return out


def _assert_tiled_close(got, ref, precision):
    ref = np.asarray(ref)
    err = np.max(np.abs(got.numpy() - ref))
    bound = TILED_TOL[precision] * np.max(np.abs(ref))
    assert err <= bound, (err, np.max(np.abs(ref)))


def test_envelope_constant_is_the_reference_one():
    assert PALLAS_ATTN_MAX_ELEMS == JAX_MAX_ELEMS == 2 ** 21


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("span_of", ["half", "whole"])
@pytest.mark.parametrize("b,h,kvh,s,hd", [
    (2, 8, 2, 512, 64),     # GQA
    (2, 4, 4, 1024, 128),   # MHA
    (3, 8, 1, 512, 128),    # MQA
])
def test_tiled_plain_matches_jax(b, h, kvh, s, hd, span_of, precision):
    span = s // 2 if span_of == "half" else s
    q, cache = _tiled_inputs(b, h, kvh, s, hd, seed=s + hd + kvh)
    rng = np.random.default_rng(b * 7 + h)
    for pos in _edge_batches(b, s, rng):
        kw = dict(precision=precision, span=span)
        ref = jax_tiled(jnp.asarray(q), *_jax_cache(cache), jnp.asarray(pos),
                        **kw)
        got = decode_attention_tiled_plain(
            torch.from_numpy(q), *_torch_cache(cache), torch.from_numpy(pos),
            **kw)
        assert got.shape == (b, h, 1, hd) and got.dtype == torch.float32
        _assert_tiled_close(got, ref, precision)
        # the wrapper takes the plain version on CPU tensors
        wrapped = decode_attention_tiled(
            torch.from_numpy(q), *_torch_cache(cache), torch.from_numpy(pos),
            **kw)
        assert torch.equal(wrapped, got)


@pytest.mark.parametrize("precision,window", [("high", 64), ("fast", 300)])
def test_tiled_plain_window_and_softcap_match_jax(precision, window):
    """Sliding window and softcap 8.0: at pos 440 and window 64 the first
    tile lies wholly before the window and drops out of the online sums.
    Window 64 runs under "high", as the reference's own test does: with 64
    live keys one bf16 rounding of p * v_scale flipped by the f32 sum
    order moves an output by ~1e-4 of max|ref| under "fast"."""
    b, h, kvh, s, hd = 2, 8, 2, 512, 64
    q, cache = _tiled_inputs(b, h, kvh, s, hd, seed=9)
    pos = np.array([300, 440], np.int32)
    kw = dict(precision=precision, span=512, window=window, softcap=8.0)
    ref = jax_tiled(jnp.asarray(q), *_jax_cache(cache), jnp.asarray(pos), **kw)
    got = decode_attention_tiled_plain(torch.from_numpy(q),
                                       *_torch_cache(cache),
                                       torch.from_numpy(pos), **kw)
    _assert_tiled_close(got, ref, precision)


@pytest.fixture
def tiled_calls(monkeypatch):
    """Count the port's calls of decode_attention_tiled, wherever routed."""
    calls = []
    real = port_attention.decode_attention_tiled

    def spy(*args, **kwargs):
        calls.append(kwargs.get("span"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_attention, "decode_attention_tiled", spy)
    return calls


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_decode_attention_delegates_past_the_envelope(precision, tiled_calls):
    """t = 1 with KVH * span * hd > 2^21 and span % 256 == 0: the reference's
    decode_attention hands over to its tiled kernel, and so does the
    port's. Before the port delegated it rounded as the single-tile form
    and differed by 2e-3 of max|ref| under "fast"."""
    b, h, kvh, s, hd = 2, 8, 8, 4096, 128
    q, cache = _tiled_inputs(b, h, kvh, s, hd, seed=41)
    pos = np.array([3000, s], np.int32)
    kw = dict(t=1, precision=precision, span=s)
    ref = jax_attend(jnp.asarray(q), *_jax_cache(cache), jnp.asarray(pos), **kw)
    got = decode_attention(torch.from_numpy(q), *_torch_cache(cache),
                           torch.from_numpy(pos), **kw)
    _assert_tiled_close(got, ref, precision)
    assert tiled_calls == [s]


def test_decode_attention_update_delegates_past_the_envelope(tiled_calls):
    """The insert-then-attend pair at t = 1 past the envelope: the same
    cache bytes and the tiled route's output."""
    b, h, kvh, s, hd = 2, 8, 8, 4096, 128
    q, cache = _tiled_inputs(b, h, kvh, s, hd, seed=43)
    rng = np.random.default_rng(44)
    kn = (rng.standard_normal((b, kvh, 1, hd)) * 2).astype(np.float32)
    vn = rng.standard_normal((b, kvh, 1, hd)).astype(np.float32)
    pos = np.array([2047, 4095], np.int32)
    ref_out, *ref_cache = jax_update(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *_jax_cache(cache),
        jnp.asarray(pos), t=1, precision="fast", span=s)
    got_cache = _torch_cache(cache)
    out, *new_cache = decode_attention_update(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        *got_cache, torch.from_numpy(pos), t=1, precision="fast", span=s)
    _assert_cache_equal(new_cache, ref_cache)
    _assert_tiled_close(out, ref_out, "fast")
    assert tiled_calls == [s]


def test_tiled_rejects_a_span_off_the_tile():
    q, cache = _tiled_inputs(1, 2, 2, 512, 64, seed=3)
    with pytest.raises(ValueError, match="multiple of 256"):
        decode_attention_tiled(torch.from_numpy(q), *_torch_cache(cache),
                               torch.zeros(1, dtype=torch.int32), span=384)
