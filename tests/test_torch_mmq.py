"""The port's Q4_K/Q5_K/Q6_K MMQ (plain PyTorch versions of kernels K1, K8
and K2) held against the JAX package's Pallas MMQ kernels (interpret mode on the CPU),
and the port's dequantization held bit-equal to the GGUF codecs."""

import os
import re

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
from gguf_tpu_torch.ops import MMQ, build, mmq_q4_k, mmq_q5_k, mmq_q6_k
from gguf_tpu_torch.ops.mmq_q4_k import (KH, KT, dequantize_q4_k_plain,
                                         k1_plan, split_k, tc_plan, tc_tile)
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


@pytest.mark.parametrize("n,tile", [
    (1, (64, 8)), (8, (64, 8)), (9, (64, 16)), (16, (64, 16)),
    (17, (64, 64)), (64, (64, 64)), (65, (128, 128)), (512, (128, 128))])
def test_tensor_core_tile_widths(n, tile):
    """K1, K2 and K12 "fast" pick their tile from n alone: one warpgroup of
    64 rows up to n = 64, two above."""
    assert tc_tile(n) == tile


_DISPATCH = re.compile(
    r"(?:if \(N <= (\d+)\)|else)\s+err = [\w:]+<(\d+), (\d+)>\(")


@pytest.mark.parametrize("source", ["mmq_q4_k.cu", "mmq_q6_k.cu",
                                    "mmq_q2_k.cu", "mmq_q5_k.cu",
                                    "mmq_iq4.cu", "mmq_legacy.cu",
                                    "mmq_q3_k.cu", "mmq_q8_0.cu"])
def test_cuda_dispatch_matches_tc_tile(source):
    """The tensor-core launch of K1, K2, K12, K8, K14, K11, K13 and K10 dispatches the
    tile that `tc_tile` (and so the wrappers' split plan) assumes, at
    every width from 1 to 512: (activation rows, warpgroups of 64 weight
    rows)."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        arms = [(int(lim) if lim else None, int(bn), int(wg))
                for lim, bn, wg in _DISPATCH.findall(f.read())]
    assert [a[0] for a in arms] == [8, 16, 64, None], arms
    for n in range(1, 513):
        bn, wg = next((bn, wg) for lim, bn, wg in arms
                      if lim is None or n <= lim)
        assert (64 * wg, bn) == tc_tile(n), (source, n)


# the tensor-core tiles of K2 and K12 "fast": the LM heads (TinyLlama and
# Llama-2-7B, Q6_K or Q2_K) and the Q2_K mix's wk, wq and gate_up at a
# decode and a prefill width
_KH_SHAPES = [(32000, 16, 2048, (1, 16)), (32000, 512, 2048, (1, 16)),
              (32000, 16, 4096, (1, 32)), (32000, 512, 4096, (1, 32)),
              (256, 16, 2048, (8, 2)), (256, 512, 2048, (8, 2)),
              (2048, 16, 2048, (8, 2)), (2048, 512, 2048, (4, 4)),
              (11264, 16, 2048, (2, 8)), (11264, 512, 2048, (1, 16))]


@pytest.mark.parametrize("m,n,k,want", _KH_SHAPES)
def test_tc_plan_of_k2_and_k12(m, n, k, want):
    """K2's and K12's wrappers split K as split_k does for their tile and
    128-element chunks at 2 blocks per SM: the 32000-row heads stay whole
    (500 row blocks fill 132 SMs), the small Q2_K weights are cut."""
    assert tc_plan(m, n, k, 132) == want
    assert want == split_k(m, n, k, 132, tc_tile(n), 2, KH)


# K8 "fast" (K1's plan: 64-element chunks, 4 blocks per SM at n <= 16)
# and K14 "fast" (tc_plan: 128-element chunks, 2 per SM) at the TinyLlama
# projections and head: (m, n, k, K8's plan, K14's plan)
_TINYLLAMA_PLANS = [
    (2560, 16, 2048, (8, 4), (6, 3)), (2560, 512, 2048, (4, 8), (4, 4)),
    (2048, 16, 2048, (8, 4), (8, 2)), (2048, 512, 2048, (5, 7), (4, 4)),
    (11264, 16, 2048, (3, 11), (2, 8)), (11264, 512, 2048, (1, 32), (1, 16)),
    (2048, 16, 5632, (8, 11), (8, 6)), (2048, 512, 5632, (5, 18), (5, 9)),
    (32000, 16, 2048, (2, 16), (1, 16)), (32000, 512, 2048, (1, 32), (1, 16))]


@pytest.mark.parametrize("m,n,k,k8,k14", _TINYLLAMA_PLANS)
@pytest.mark.parametrize("kernel", ["k8", "k14"])
def test_split_plan_of_k8_and_k14(kernel, m, n, k, k8, k14):
    """K8's wrapper splits K as K1's does (`k1_plan`) and K14's as K2's and
    K12's do (`tc_plan`): every split holds a chunk, as the C entry points
    check, and the 32000-row heads stay whole under `tc_plan`."""
    plan, kt, want = ((k1_plan, KT, k8) if kernel == "k8"
                      else (tc_plan, KH, k14))
    splits, per = plan(m, n, k, 132)
    assert (splits, per) == want
    assert (splits - 1) * per < k // kt <= splits * per


@pytest.mark.parametrize("m,n,k,tile,per_sm,kt,want", [
    # K1 "fast" at decode widths asks for 4 blocks per SM
    (11264, 16, 2048, (64, 16), 4, 64, (3, 11)),
    (2560, 16, 2048, (64, 16), 4, 64, (8, 4)),
    (256, 16, 2048, (64, 16), 4, 64, (8, 4)),     # the Q2_K mix's wv
    (22016, 16, 4096, (64, 16), 4, 64, (2, 32)),  # Llama-2-7B gate_up
    # K1 "fast" at the 512-token prefill chunk: enough blocks, no split
    (11264, 512, 2048, (128, 128), 2, 64, (1, 32)),
    (2048, 512, 2048, (128, 128), 2, 64, (5, 7)),
    # K7: 128-element chunks
    (11264, 16, 2048, None, 2, 128, (2, 8)),
    (256, 4, 2048, None, 2, 128, (8, 2)),
    # K2 and K12 "fast": 128-element chunks, 2 blocks per SM
    *[(m, n, k, tc_tile(n), 2, KH, want) for m, n, k, want in _KH_SHAPES],
])
def test_split_k_of_the_tensor_core_tiles(m, n, k, tile, per_sm, kt, want):
    """The wrappers' split of K for K1 "fast", K7, K2 and K12 on 132 SMs:
    every split holds at least one chunk, as the launch functions check."""
    splits, per = split_k(m, n, k, 132, tile, per_sm, kt)
    assert (splits, per) == want
    chunks = k // kt
    assert (splits - 1) * per < chunks <= splits * per
