"""The port's copies for the 32-element-block formats and their Q8_0 MMQ,
held against the JAX package: the quantizers byte-identical to
`gguf_tpu.quant` for all eight formats the port reads, `QuantWeight
.dequantize()` bit-equal to `QuantTensor.dequantize()`, the plain version
of K10 (`mmq_q8_0`) against `gguf_tpu.ops.mmq_q8_0` (Pallas in interpret
mode) and the byte-level golden, and `gguf_tpu_torch.compat` against
`gguf_tpu.compat`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gguf_tpu.compat as jax_compat
import gguf_tpu.quant as jax_quant
from gguf_tpu.ops import mmq_q8_0 as jax_mmq_q8_0
from gguf_tpu.quant import mmq_q8_0_q8_1_golden, quantize_q8_1
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err
from gguf_tpu_torch import compat
from gguf_tpu_torch.ops import MMQ, mmq_q8_0
from gguf_tpu_torch.ops.mmq_q8_0 import mmq_q8_0_plain, split_k
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight, concat_m

FORMATS = ("q4_k", "q5_k", "q6_k", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1")
# "fast" rounds operands to bf16 (both sides the same values), so only the
# f32 summation order differs; the bounds are relative to max|ref|
TOL = {"fast": 1e-3, "high": 1e-5}
# tests/test_mmq_pallas.py: the golden consumes the Q8_1 codec's bytes
GOLDEN_TOL = 0.01


def _awkward(m: int, k: int, seed: int) -> np.ndarray:
    """Gaussian rows with the blocks a codec gets wrong first: all zero,
    tiny (1e-7, below fp16's normal range), all one sign, and +-large."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0
    if m > 1:
        x[1, :32] = 1e-7
        x[1, 32:64] = np.abs(x[1, 32:64])
    if m > 2:
        x[2, :64] *= 1e4
        x[2, 64:96] *= -1e4
    return x


def _assert_close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.filterwarnings("ignore:divide by zero")
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizers_byte_identical_to_jax(fmt):
    x = _awkward(8, 512, seed=FORMATS.index(fmt))
    want = getattr(jax_quant, f"quantize_{fmt}")(x)
    got = QUANTIZERS[fmt](x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("fmt,k", [("q8_0", 48), ("q4_0", 96), ("q5_1", 32),
                                   ("q6_k", 128)])
def test_block_multiple_of_k_is_enforced(fmt, k):
    """K % 32 for Q8_0, K % 256 for the legacy formats (the JAX package's
    `mmq_legacy` demands it) and the K-quants."""
    with pytest.raises(ValueError, match="multiple"):
        QuantWeight.from_blocks(fmt, np.zeros(4 * k, np.uint8), (1, k), "cpu")


def _q8_0(m, k, seed):
    raw = QUANTIZERS["q8_0"](_awkward(m, k, seed))
    return raw, to_soa("q8_0", raw, m, k), QuantWeight.from_blocks(
        "q8_0", raw, (m, k), "cpu")


def _acts(n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)) * rng.uniform(0.1, 4, (n, 1))
            ).astype(np.float32)


# (precision, act_quant) cases the JAX Q8_0 MMQ runs on the CPU at n: under
# act_quant + "fast" at 16 and 64 rows XLA's CPU dot has no bf16 x bf16 ->
# f32 form for the shapes the kernel then takes
def _modes(n):
    return [("high", False), ("fast", False), ("high", True)] + (
        [] if n in (16, 64) else [("fast", True)])


@pytest.mark.parametrize("k", [32, 64, 96, 128])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_mmq_q8_0_matches_jax_reference_sweep(m, n, k):
    """The reference's shape sweep, K from one block to four (K = 32 and
    96 end on a half step of the kernel's 64-element K loop)."""
    _, wj, wt = _q8_0(m, k, seed=m * 100 + n * 10 + k)
    b = _acts(n, k, seed=k + n)
    for precision, act_quant in _modes(n):
        ref = np.asarray(jax_mmq_q8_0(wj, jnp.asarray(b), act_quant=act_quant,
                                      precision=precision))
        got = mmq_q8_0(wt, torch.from_numpy(b), precision=precision,
                       act_quant=act_quant)
        assert got.shape == (n, m) and got.dtype == torch.float32
        _assert_close(got.numpy(), ref, TOL[precision])


@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("n", [64, 65])
def test_mmq_q8_0_matches_jax_both_width_arms(n, k):
    """n_pad <= 64 takes the reference's decode arm, 65 its prefill arm."""
    _, wj, wt = _q8_0(256, k, seed=n + k)
    b = _acts(n, k, seed=n)
    for precision, act_quant in _modes(n):
        ref = jax_mmq_q8_0(wj, jnp.asarray(b), act_quant=act_quant,
                           precision=precision)
        got = mmq_q8_0(wt, torch.from_numpy(b), precision=precision,
                       act_quant=act_quant)
        _assert_close(got.numpy(), ref, TOL[precision])


@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_mmq_q8_0_act_quant_matches_golden(n, k):
    """act_quant + "high" against the byte-level golden, which consumes
    the Q8_1 codec's bytes of the same activations."""
    rng = np.random.default_rng(n * k)
    a = rng.standard_normal((16, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float16)
    raw = QUANTIZERS["q8_0"](a)
    want = mmq_q8_0_q8_1_golden(raw, quantize_q8_1(b), 16, n, k)
    got = mmq_q8_0(QuantWeight.from_blocks("q8_0", raw, (16, k), "cpu"),
                   torch.from_numpy(b.astype(np.float32)), act_quant=True,
                   precision="high").numpy()
    assert allclose_rel(got, want, GOLDEN_TOL), max_rel_err(got, want)


def test_bf16_activations_equal_f32_of_same_values():
    _, _, w = _q8_0(64, 256, seed=3)
    b = torch.from_numpy(_acts(4, 256, seed=4)).bfloat16()
    torch.testing.assert_close(mmq_q8_0(w, b, precision="fast"),
                               mmq_q8_0(w, b.float(), precision="fast"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k", "q5_k", "q6_k"])
@pytest.mark.parametrize("n", [1, 16])
def test_compat_matches_jax_compat(fmt, n):
    """The reference's calling convention on the CPU: raw bytes, (N, K)
    activations, (N, M) out; act_quant and "high" by default, as in
    `gguf_tpu.compat`."""
    m, k = 16, 256
    raw = QUANTIZERS[fmt](_awkward(m, k, seed=n))
    b = _acts(n, k, seed=n + 1)
    ref = getattr(jax_compat, f"mmq_{fmt}")(raw, b, m, n, k)
    got = getattr(compat, f"mmq_{fmt}")(raw, b, m, n, k, device="cpu")
    assert got.shape == (n, m)
    _assert_close(got.numpy(), ref, TOL["high"])
    got = getattr(compat, f"mmq_{fmt}")(torch.from_numpy(raw),
                                        torch.from_numpy(b), m, n, k,
                                        device="cpu", act_quant=False)
    ref = getattr(jax_compat, f"mmq_{fmt}")(raw, b, m, n, k, act_quant=False)
    _assert_close(got.numpy(), ref, TOL["high"])


def test_compat_unported_formats_raise():
    """Every entry point of the reference's compat is ported (Q2_K and Q3_K
    in tests/test_torch_kquant_low.py); bytes of a format the port does
    not read raise."""
    with pytest.raises(NotImplementedError, match="not supported"):
        compat._mmq("iq2_xxs", np.zeros(66, np.uint8),
                    np.zeros((1, 256), np.float32), 1, 1, 256, device="cpu")


def test_split_k_fills_the_card_at_decode_widths():
    """132 SMs: M = 2048 at n = 16 gives 32 blocks, so K is cut into 8
    ranges; the 11264-row gate_up and the 32000-row head need fewer or
    none; every split holds at least one K step."""
    assert split_k(2048, 16, 2048, 132) == (8, 4)
    assert split_k(11264, 16, 2048, 132) == (2, 16)
    assert split_k(32000, 16, 2048, 132) == (1, 32)
    assert split_k(16, 4, 32, 132) == (1, 1)
    for m, n, k in ((1, 1, 96), (2048, 512, 5632), (4, 16, 128)):
        splits, per = split_k(m, n, k, 132)
        steps = -(-k // 64)
        assert (splits - 1) * per < steps <= splits * per


def test_operand_checks_and_launch_counters():
    _, _, w = _q8_0(16, 256, seed=5)
    with pytest.raises(ValueError):
        mmq_q8_0(w, torch.zeros(2, 288))
    with pytest.raises(ValueError, match="precision"):
        mmq_q8_0(w, torch.zeros(2, 256), precision="medium")
    with pytest.raises(ValueError):
        MMQ["q4_0"](w, torch.zeros(2, 256))          # wrong format
    with pytest.raises(NotImplementedError, match="no MMQ kernel"):
        MMQ["iq2_xxs"]
    before = mmq_q8_0.launches
    x = torch.from_numpy(_acts(3, 256, seed=6))
    for kw in ({}, {"act_quant": True}, {"precision": "fast"}):
        assert mmq_q8_0(w, x, **kw).shape == (3, 16)
    assert mmq_q8_0.launches == before
    assert torch.equal(mmq_q8_0(w, x), mmq_q8_0_plain(w, x))
