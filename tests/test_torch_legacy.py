"""The plain version of K11 (`mmq_q4_0` .. `mmq_q5_1`) held against the
JAX package's `mmq_legacy` (Pallas in interpret mode on the CPU) and the
byte-level goldens, including the reference's split "fast" product and
its fp16 block sums under act_quant."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gguf_tpu.ops as jax_ops
import gguf_tpu.quant as jax_quant
from gguf_tpu.quant import quantize_q8_1
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err
from gguf_tpu_torch.ops import MMQ, mmq_legacy
from gguf_tpu_torch.ops.mmq_legacy import mmq_legacy_plain
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight

LEGACY = ("q4_0", "q4_1", "q5_0", "q5_1")
# "fast" rounds both operands of the main term to bf16 on both sides, so
# only the f32 summation order differs; the bounds are relative to
# max|ref|. Under act_quant the block sums go through fp16 on both sides:
# each is d8 times an integer below 2^12, exact in f32 in any order, so no
# fp16 rounding can flip between the two summation orders and the same
# bounds hold.
TOL = {"fast": 1e-3, "high": 1e-5}
GOLDEN_TOL = 0.01     # tests/test_mmq_pallas.py
MODES = [(p, aq) for p in ("high", "fast") for aq in (False, True)]


def _weight(fmt, m, k, seed):
    rng = np.random.default_rng(seed)
    raw = QUANTIZERS[fmt](rng.standard_normal((m, k)).astype(np.float32))
    return raw, to_soa(fmt, raw, m, k), QuantWeight.from_blocks(
        fmt, raw, (m, k), "cpu")


def _acts(n, k, seed):
    """Activations at several scales, with an all-zero block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k)) * rng.uniform(0.1, 4, (n, 1))
         ).astype(np.float32)
    x[:, 32:64] = 0.0
    return x


def _assert_close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _check(fmt, wj, wt, b, modes=MODES):
    for precision, act_quant in modes:
        ref = getattr(jax_ops, f"mmq_{fmt}")(
            wj, jnp.asarray(b), act_quant=act_quant, precision=precision)
        got = MMQ[fmt](wt, torch.from_numpy(b), precision=precision,
                       act_quant=act_quant)
        assert got.shape == ref.shape and got.dtype == torch.float32
        _assert_close(got.numpy(), ref, TOL[precision])


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("fmt", LEGACY)
def test_mmq_legacy_matches_jax_reference_sweep(fmt, m, n):
    """The reference's M, N sweep at K = 256 (the legacy MMQ's K step),
    both precisions, with and without act_quant."""
    _, wj, wt = _weight(fmt, m, 256, seed=m * 10 + n)
    _check(fmt, wj, wt, _acts(n, 256, seed=n))


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("fmt", LEGACY)
def test_mmq_legacy_matches_jax_both_width_arms(fmt, n):
    """n_pad <= 64: the reference's decode arm (block sums in-kernel);
    65: its prefill arm (block sums in XLA)."""
    _, wj, wt = _weight(fmt, 256, 512, seed=n)
    _check(fmt, wj, wt, _acts(n, 512, seed=n + 1))


@pytest.mark.parametrize("fmt", ["q4_0", "q5_0"])
def test_fast_contract_is_the_split_product(fmt):
    """A block whose codes straddle the offset (both signs of q - off) and
    whose activations are all one sign: the reference's "fast" main term
    rounds d*q (raw code) to bf16 and adds -off*d*bsum in f32. The port
    matches it, and rounding d*(q - off) to bf16 instead does not."""
    m, k, n = 64, 256, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, :32] = np.linspace(-1.0, 0.93, 32, dtype=np.float32) * 3.3
    raw = QUANTIZERS[fmt](x)
    wj = to_soa(fmt, raw, m, k)
    w = QuantWeight.from_blocks(fmt, raw, (m, k), "cpu")
    b = np.abs(_acts(n, k, seed=2)) + 1.0
    ref = np.asarray(getattr(jax_ops, f"mmq_{fmt}")(
        wj, jnp.asarray(b), act_quant=False, precision="fast"))
    got = mmq_legacy(w, torch.from_numpy(b), precision="fast").numpy()
    _assert_close(got, ref, TOL["fast"])
    codes = w.dequantize()[:, :32] / torch.from_numpy(
        raw.reshape(m, -1)[:, :2].copy()).view(torch.float16).float()
    off = 8 if fmt == "q4_0" else 16
    assert (codes < 0).any() and (codes > 0).any() and codes.abs().max() <= off
    naive = (torch.from_numpy(b).bfloat16().float()
             @ w.dequantize().bfloat16().float().T).numpy()
    assert np.max(np.abs(naive - ref)) > TOL["fast"] * np.max(np.abs(ref))


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("fmt", LEGACY)
def test_act_quant_matches_golden(fmt, n):
    """act_quant + "high" against the byte-level golden (its s field from
    the Q8_1 codec's bytes of the same activations)."""
    m, k = 16, 512
    rng = np.random.default_rng(n + 7)
    a = rng.standard_normal((m, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float16)
    raw = QUANTIZERS[fmt](a)
    want = getattr(jax_quant, f"mmq_{fmt}_q8_1_golden")(
        raw, quantize_q8_1(b), m, n, k)
    got = MMQ[fmt](QuantWeight.from_blocks(fmt, raw, (m, k), "cpu"),
                   torch.from_numpy(b.astype(np.float32)), act_quant=True,
                   precision="high").numpy()
    assert allclose_rel(got, want, GOLDEN_TOL), max_rel_err(got, want)


def test_act_quant_block_sums_round_through_fp16():
    """The act_quant route is fake-quant, then the split product with the
    block sums rounded through fp16 (Q8_1's s): the plain version with
    `fp16_bsum` on K6's output, which differs from the unrounded sums."""
    from gguf_tpu_torch.ops import fake_quantize_q8_1

    _, _, w = _weight("q4_1", 32, 256, seed=3)
    x = torch.from_numpy(_acts(4, 256, seed=4) * 37.0)
    fq = fake_quantize_q8_1(x)
    got = mmq_legacy(w, x, act_quant=True)
    assert torch.equal(got, mmq_legacy_plain(w, fq, fp16_bsum=True))
    assert not torch.equal(got, mmq_legacy_plain(w, fq))


def test_operand_checks_and_launch_counters():
    _, _, w = _weight("q5_1", 16, 256, seed=5)
    with pytest.raises(ValueError):
        MMQ["q5_0"](w, torch.zeros(2, 256))              # wrong format
    with pytest.raises(ValueError):
        mmq_legacy(w, torch.zeros(2, 512))
    _, _, wq8 = _weight("q8_0", 16, 256, seed=5)
    with pytest.raises(ValueError, match="mmq_legacy takes"):
        mmq_legacy(wq8, torch.zeros(2, 256))
    before = mmq_legacy.launches
    for fmt in LEGACY:
        _, _, wf = _weight(fmt, 16, 256, seed=6)
        for kw in ({}, {"act_quant": True}, {"precision": "fast"}):
            assert MMQ[fmt](wf, torch.ones(3, 256), **kw).shape == (3, 16)
    assert mmq_legacy.launches == before
