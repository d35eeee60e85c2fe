"""The port's IQ4_NL and IQ4_XS path held against the JAX package: the
numpy quantizers byte-identical to `gguf_tpu.quant`, `QuantWeight
.dequantize()` bit-equal to `QuantTensor.dequantize()`, and the plain
version of K14 (`mmq_iq4_nl`, `mmq_iq4_xs`, one kernel and one launch
counter) against the Pallas kernel in interpret mode in both width arms
and against the byte-level goldens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gguf_tpu.ops as jax_ops
import gguf_tpu.quant as jax_quant
from gguf_tpu.quant import quantize_q8_1
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err
from gguf_tpu_torch.ops import MMQ, mmq_iq4, mmq_iq4_nl, mmq_iq4_xs
from gguf_tpu_torch.ops.mmq_iq4 import mmq_iq4_plain
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight, concat_m
from gguf_tpu_torch.quant.iq4 import KVALUES

FORMATS = ("iq4_nl", "iq4_xs")
# the element value d*KV[q] (or d*ls*KV[q]) is exact in f32, and "fast"
# rounds both operands to bf16 on both sides: only the f32 summation
# order differs; bounds relative to max|ref|
TOL = {"fast": 1e-3, "high": 1e-5}
GOLDEN_TOL = 0.01     # tests/test_mmq_pallas.py
# every (precision, act_quant) the JAX kernel runs on the CPU at n (under
# act_quant + "fast" at n = 40 XLA's CPU dot has no bf16 x bf16 -> f32
# form for the shapes the kernel then takes)
CASES = [(n, p, aq) for n in (4, 40, 96) for p in ("high", "fast")
         for aq in (False, True) if (n, p, aq) != (40, "fast", True)]


def _weight(fmt, m, k, seed):
    rng = np.random.default_rng(seed)
    raw = QUANTIZERS[fmt](rng.standard_normal((m, k)).astype(np.float32))
    return raw, to_soa(fmt, raw, m, k), QuantWeight.from_blocks(
        fmt, raw, (m, k), "cpu")


def _acts(n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)) * rng.uniform(0.1, 4, (n, 1))
            ).astype(np.float32)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref)))


def _awkward(m: int, k: int, seed: int) -> np.ndarray:
    """Gaussian rows with an all-zero, a tiny, a one-signed and a +-large
    block (the sub-block scales of IQ4_XS then span their 6-bit range)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0
    x[1, :32] = 1e-7
    x[1, 32:64] = np.abs(x[1, 32:64])
    x[2, :64] *= 1e4
    x[2, 64:96] *= -1e4
    return x


def test_codebook_is_ggml_kvalues():
    np.testing.assert_array_equal(KVALUES, jax_quant.iq4.KVALUES)


@pytest.mark.filterwarnings("ignore:invalid value")
@pytest.mark.filterwarnings("ignore:divide by zero")
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizers_byte_identical_to_jax(fmt):
    x = _awkward(8, 512, seed=FORMATS.index(fmt))
    got = QUANTIZERS[fmt](x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got,
                                  getattr(jax_quant, f"quantize_{fmt}")(x))


@pytest.mark.filterwarnings("ignore:invalid value")
@pytest.mark.filterwarnings("ignore:divide by zero")
@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_bit_equal_to_jax(fmt):
    """Also: blocks() gives back the file bytes, and take_rows / concat_m
    act on whole rows of every field."""
    m, k = 8, 512
    raw = QUANTIZERS[fmt](_awkward(m, k, seed=10 + FORMATS.index(fmt)))
    w = QuantWeight.from_blocks(fmt, raw, (m, k), "cpu")
    ref = np.asarray(to_soa(fmt, raw, m, k).dequantize())
    got = w.dequantize()
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(w.blocks().numpy().reshape(-1), raw)
    ids = torch.tensor([5, 0, 2])
    np.testing.assert_array_equal(w.take_rows(ids).dequantize().numpy(),
                                  ref[[5, 0, 2]])
    both = concat_m([w, w.take_rows(ids)])
    np.testing.assert_array_equal(both.dequantize().numpy(),
                                  np.concatenate([ref, ref[[5, 0, 2]]]))


@pytest.mark.parametrize("fmt,nbytes", [("iq4_nl", 18 * 7), ("iq4_xs", 136)])
def test_k_multiple_of_256_is_enforced(fmt, nbytes):
    """K % 256 for both, IQ4_NL's 32-element blocks included: the JAX
    package's `mmq_iq4_nl` demands it."""
    k = 224 if fmt == "iq4_nl" else 128
    with pytest.raises(ValueError, match="multiple of 256"):
        QuantWeight.from_blocks(fmt, np.zeros(nbytes, np.uint8), (1, k),
                                "cpu")


@pytest.mark.parametrize("n,precision,act_quant", CASES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_mmq_matches_jax_both_width_arms(fmt, n, precision, act_quant):
    """n = 4 and 40 take the reference's decode arm, 96 its prefill arm;
    act_quant fake-quantizes first at every width."""
    _, wj, wt = _weight(fmt, 64, 512, seed=n)
    b = _acts(n, 512, seed=n + 1)
    ref = getattr(jax_ops, f"mmq_{fmt}")(wj, jnp.asarray(b),
                                          act_quant=act_quant,
                                          precision=precision)
    got = MMQ[fmt](wt, torch.from_numpy(b), precision=precision,
                   act_quant=act_quant)
    assert got.shape == (n, 64) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL[precision]


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_act_quant_matches_golden(fmt, m, n):
    """act_quant + "high" against the byte-level golden (the reference's
    M, N sweep), which consumes the Q8_1 codec's bytes of the same
    activations."""
    k = 512
    rng = np.random.default_rng(m * 10 + n)
    a = rng.standard_normal((m, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float16)
    raw = QUANTIZERS[fmt](a)
    want = getattr(jax_quant, f"mmq_{fmt}_q8_1_golden")(
        raw, quantize_q8_1(b), m, n, k)
    got = MMQ[fmt](QuantWeight.from_blocks(fmt, raw, (m, k), "cpu"),
                   torch.from_numpy(b.astype(np.float32)), act_quant=True,
                   precision="high").numpy()
    assert allclose_rel(got, want, GOLDEN_TOL), max_rel_err(got, want)


def test_wrappers_share_one_kernel_and_counter():
    _, _, wnl = _weight("iq4_nl", 16, 256, seed=3)
    _, _, wxs = _weight("iq4_xs", 16, 256, seed=3)
    with pytest.raises(ValueError):
        mmq_iq4_nl(wxs, torch.zeros(2, 256))             # wrong format
    with pytest.raises(ValueError):
        mmq_iq4_xs(wnl, torch.zeros(2, 256))
    _, _, wq4 = _weight("q4_0", 16, 256, seed=3)
    with pytest.raises(ValueError, match="mmq_iq4 takes"):
        mmq_iq4(wq4, torch.zeros(2, 256))
    with pytest.raises(ValueError):
        mmq_iq4(wnl, torch.zeros(2, 512))                # wrong K
    before = mmq_iq4.launches
    x = torch.from_numpy(_acts(3, 256, seed=4))
    for fn, w in ((mmq_iq4_nl, wnl), (mmq_iq4_xs, wxs)):
        for kw in ({}, {"act_quant": True}, {"precision": "fast"}):
            assert fn(w, x, **kw).shape == (3, 16)
        assert torch.equal(fn(w, x), mmq_iq4_plain(w, x))
    assert mmq_iq4.launches == before
    assert MMQ["iq4_nl"] is mmq_iq4_nl and MMQ["iq4_xs"] is mmq_iq4_xs
