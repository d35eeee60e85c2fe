"""The port's Q4_K/Q5_K/Q6_K MMQ (plain PyTorch versions of kernels K1, K8
and K2) held against the JAX package's Pallas MMQ kernels (interpret mode on the CPU),
and the port's dequantization held bit-equal to the GGUF codecs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gguf_tpu.ops import mmq_q4_k as jax_mmq_q4_k
from gguf_tpu.ops import mmq_q5_k as jax_mmq_q5_k
from gguf_tpu.ops import mmq_q6_k as jax_mmq_q6_k
from gguf_tpu.quant import (dequantize_q4_k, dequantize_q5_k, dequantize_q6_k,
                            quantize_q4_k, quantize_q5_k, quantize_q6_k)
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu_torch.ops import MMQ, mmq_q4_k, mmq_q5_k, mmq_q6_k
from gguf_tpu_torch.ops.mmq_q4_k import dequantize_q4_k_plain
from gguf_tpu_torch.ops.mmq_q5_k import dequantize_q5_k_plain
from gguf_tpu_torch.ops.mmq_q6_k import dequantize_q6_k_plain
from gguf_tpu_torch.quant import QuantWeight, concat_m

M, K = 256, 512
QUANTIZE = {"q4_k": quantize_q4_k, "q5_k": quantize_q5_k,
            "q6_k": quantize_q6_k}
CODEC = {"q4_k": dequantize_q4_k, "q5_k": dequantize_q5_k,
         "q6_k": dequantize_q6_k}
# "fast" rounds operands to bf16: where XLA fuses the dequant into an FMA a
# weight can land one bf16 ulp away, so the bound is relative to max|ref|
TOL = {"fast": 1e-3, "high": 1e-5}


def _weight(fmt, m=M, k=K, seed=0):
    rng = np.random.default_rng(seed)
    raw = QUANTIZE[fmt](rng.standard_normal((m, k)).astype(np.float32))
    return raw, to_soa(fmt, raw, m, k), QuantWeight.from_blocks(
        fmt, raw, (m, k), "cpu")


def _acts(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _assert_close(got, ref, precision):
    err = np.max(np.abs(got - ref))
    assert err <= TOL[precision] * np.max(np.abs(ref)), (
        err, np.max(np.abs(ref)))


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q5_k"])
def test_dequantize_bit_equal_to_codec(fmt):
    raw, _, w = _weight(fmt)
    ref = CODEC[fmt](raw, (M, K))
    np.testing.assert_array_equal(w.dequantize().numpy(), ref)
    plain = {"q4_k": dequantize_q4_k_plain, "q5_k": dequantize_q5_k_plain,
             "q6_k": dequantize_q6_k_plain}
    np.testing.assert_array_equal(plain[fmt](w).numpy(), ref)
    np.testing.assert_array_equal(w.blocks().numpy().reshape(-1), raw)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("glu", [None, "silu", "gelu"])
@pytest.mark.parametrize("n", [1, 8, 16, 64, 72, 256])
def test_mmq_q4_k_matches_jax(n, glu, precision):
    _, wj, wt = _weight("q4_k", seed=n)
    b = _acts(n, 2 * K if glu else K, seed=n + 1)
    ref = np.asarray(jax_mmq_q4_k(wj, jnp.asarray(b), act_quant=False,
                                  precision=precision, glu=glu))
    got = mmq_q4_k(wt, torch.from_numpy(b), precision=precision, glu=glu)
    assert got.shape == (n, M) and got.dtype == torch.float32
    _assert_close(got.numpy(), ref, precision)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("n", [1, 8, 16, 64, 72, 256])
def test_mmq_q6_k_matches_jax(n, precision):
    _, wj, wt = _weight("q6_k", seed=100 + n)
    b = _acts(n, K, seed=n + 2)
    ref = np.asarray(jax_mmq_q6_k(wj, jnp.asarray(b), act_quant=False,
                                  precision=precision))
    got = mmq_q6_k(wt, torch.from_numpy(b), precision=precision)
    _assert_close(got.numpy(), ref, precision)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("n", [1, 8, 16, 64, 72, 256])
def test_mmq_q5_k_matches_jax(n, precision):
    _, wj, wt = _weight("q5_k", seed=200 + n)
    b = _acts(n, K, seed=n + 3)
    ref = np.asarray(jax_mmq_q5_k(wj, jnp.asarray(b), act_quant=False,
                                  precision=precision))
    got = mmq_q5_k(wt, torch.from_numpy(b), precision=precision)
    assert got.shape == (n, M) and got.dtype == torch.float32
    _assert_close(got.numpy(), ref, precision)


def test_q5_k_codes_carry_the_fifth_bit():
    """A Q5_K weight whose every code is >= 16 dequantizes to the codec's
    values, which the Q4_K nibbles alone cannot reach."""
    raw, _, _ = _weight("q5_k", m=4, seed=9)
    blk = raw.reshape(4, K // 256, 176).copy()
    blk[:, :, 16:48] = 0xFF                 # every fifth bit set
    w = QuantWeight.from_blocks("q5_k", blk, (4, K), "cpu")
    np.testing.assert_array_equal(dequantize_q5_k_plain(w).numpy(),
                                  dequantize_q5_k(blk.reshape(-1), (4, K)))


def test_bf16_activations_equal_f32_of_same_values():
    """The port's linear() hands bf16 activations straight to the MMQ; under
    "fast" that is the same product as their f32 widening."""
    _, _, w = _weight("q4_k", seed=3)
    b = torch.from_numpy(_acts(4, K, seed=4)).bfloat16()
    torch.testing.assert_close(mmq_q4_k(w, b, precision="fast"),
                               mmq_q4_k(w, b.float(), precision="fast"),
                               rtol=0, atol=0)


def test_concat_m_is_row_concat():
    _, _, a = _weight("q6_k", m=256, seed=5)
    _, _, b = _weight("q6_k", m=512, seed=6)
    ab = concat_m([a, b])
    assert ab.shape == (768, K)
    x = torch.from_numpy(_acts(3, K, seed=7))
    torch.testing.assert_close(
        mmq_q6_k(ab, x), torch.cat([mmq_q6_k(a, x), mmq_q6_k(b, x)], dim=1),
        rtol=0, atol=0)


def test_operand_checks_and_unported_formats():
    _, _, w = _weight("q4_k", seed=8)
    with pytest.raises(ValueError):
        mmq_q4_k(w, torch.zeros(2, K + 256))
    with pytest.raises(ValueError):
        mmq_q4_k(w, torch.zeros(2, K), glu="silu")      # needs (N, 2K)
    with pytest.raises(ValueError):
        mmq_q6_k(w, torch.zeros(2, K))                  # wrong format
    with pytest.raises(ValueError):
        mmq_q5_k(w, torch.zeros(2, K))
    with pytest.raises(ValueError, match="precision"):
        mmq_q5_k(w, torch.zeros(2, K), precision="medium")
    with pytest.raises(NotImplementedError, match="no MMQ kernel"):
        MMQ["iq2_xs"]


def test_cpu_tensors_never_count_kernel_launches():
    _, _, w = _weight("q4_k", seed=9)
    before = mmq_q4_k.launches
    mmq_q4_k(w, torch.zeros(1, K))
    assert mmq_q4_k.launches == before
