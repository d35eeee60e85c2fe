"""The port's Q2_K and Q3_K path held against the JAX package: the C-core
quantizers byte-identical to `gguf_tpu.quant`, `QuantWeight.dequantize()`
bit-equal to `QuantTensor.dequantize()`, the plain versions of K12
(`mmq_q2_k`) and K13 (`mmq_q3_k`) against the Pallas kernels in interpret
mode in both width arms and against the byte-level goldens, the Q2_K arm
choice pinned, and `gguf_tpu_torch.compat` against `gguf_tpu.compat`;
K13's tensor-core decode run in numpy, and its CUDA dispatch pinned."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gguf_tpu.compat as jax_compat
import gguf_tpu.ops as jax_ops
import gguf_tpu.quant as jax_quant
from gguf_tpu.quant import quantize_q8_1
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err
from gguf_tpu_torch import compat
from gguf_tpu_torch.ops import MMQ, build, mmq_q2_k, mmq_q3_k
from gguf_tpu_torch.ops.mmq_q2_k import mmq_q2_k_plain, split_arm
from gguf_tpu_torch.ops.mmq_q4_k import tc_plan, tc_tile
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight, concat_m

FORMATS = ("q2_k", "q3_k")
# "fast" rounds both operands of the main term to bf16 on both sides, so
# only the f32 summation order differs (for Q2_K's split arm also the order
# of the per-16 sums of the rounded activations); bounds relative to
# max|ref|
TOL = {"fast": 1e-3, "high": 1e-5}
GOLDEN_TOL = 0.01     # tests/test_mmq_pallas.py
# widths on both sides of the reference's n_pad <= 64 arm, and every
# (precision, act_quant) the JAX kernels run there on the CPU: under
# act_quant + "fast" at n = 40 XLA's CPU dot has no bf16 x bf16 -> f32 form
# for the shapes the kernel then takes
CASES = [(n, p, aq) for n in (4, 40, 96) for p in ("high", "fast")
         for aq in (False, True) if (n, p, aq) != (40, "fast", True)]


def _awkward(m: int, k: int, seed: int) -> np.ndarray:
    """Gaussian rows with the blocks a codec gets wrong first: all zero,
    tiny, all one sign, and +-large."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0
    x[1, :32] = 1e-7
    x[1, 32:64] = np.abs(x[1, 32:64])
    x[2, :64] *= 1e4
    x[2, 64:96] *= -1e4
    return x


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


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizers_byte_identical_to_jax(fmt):
    x = _awkward(8, 512, seed=FORMATS.index(fmt))
    got = QUANTIZERS[fmt](x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got,
                                  getattr(jax_quant, f"quantize_{fmt}")(x))


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


@pytest.mark.parametrize("fmt", FORMATS)
def test_k_multiple_of_256_is_enforced(fmt):
    with pytest.raises(ValueError, match="multiple of 256"):
        QuantWeight.from_blocks(fmt, np.zeros(84, np.uint8), (1, 128), "cpu")


@pytest.mark.parametrize("n,precision,act_quant", CASES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_mmq_matches_jax_both_width_arms(fmt, n, precision, act_quant):
    """n = 4 and 40 take the reference's split (decode) arm, 96 its folded
    (prefill) arm; act_quant fake-quantizes first at every width."""
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
    """act_quant + "high" against the byte-level golden, which consumes
    the Q8_1 codec's bytes of the same activations (the reference's M, N
    sweep)."""
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


def test_q2_k_arm_follows_the_padded_width():
    """The split arm at n_pad = max(8, round_up(n, 8)) <= 64, the folded
    one above: n = 64 and 57 split, 65 folded."""
    assert [split_arm(n) for n in (1, 8, 57, 64, 65, 96, 512)] == \
        [True, True, True, True, False, False, False]


def test_q2_k_arm_is_the_tensor_core_tiles_arm():
    """K12 "fast" takes its arm from its tensor-core tile (csrc/mmq_q2_k.cu:
    the split arm on the one-warpgroup tiles, folded on the two-warpgroup
    one): at every width from 1 to 512 that is the reference's arm."""
    for n in range(1, 513):
        assert split_arm(n) == (tc_tile(n)[0] == 64), n


@pytest.mark.parametrize("n", [4, 96])
def test_q2_k_wrong_arm_misses_the_reference(n):
    """Under "fast" the two arms differ by whole bf16 ulps of the staged
    weight (rounded with and without its min): the plain version in the
    arm the reference takes at n is within 1e-3, the other arm is not."""
    _, wj, wt = _weight("q2_k", 64, 512, seed=n)
    b = _acts(n, 512, seed=n + 1)
    ref = jax_ops.mmq_q2_k(wj, jnp.asarray(b), act_quant=False,
                           precision="fast")
    x = torch.from_numpy(b)
    right = mmq_q2_k_plain(wt, x, precision="fast", split=split_arm(n))
    wrong = mmq_q2_k_plain(wt, x, precision="fast", split=not split_arm(n))
    assert _rel(right.numpy(), ref) <= TOL["fast"]
    assert _rel(wrong.numpy(), ref) > TOL["fast"]


def test_q2_k_split_sums_the_rounded_activations():
    """The split arm's min term takes the per-16 sums of the activations
    as rounded to bf16 under "fast": with unrounded sums the plain version
    misses the reference."""
    _, wj, wt = _weight("q2_k", 64, 512, seed=5)
    b = _acts(4, 512, seed=6)
    ref = jax_ops.mmq_q2_k(wj, jnp.asarray(b), act_quant=False,
                           precision="fast")
    assert _rel(mmq_q2_k(wt, torch.from_numpy(b), precision="fast"),
                ref) <= TOL["fast"]
    from gguf_tpu_torch.quant.layouts import q2_k_parts
    scale16, min16, q = q2_k_parts(wt)
    x = torch.from_numpy(b)
    main = x.bfloat16().float() @ (scale16[..., None] * q).view(
        64, 512).bfloat16().float().T
    unrounded = main - x.view(4, 32, 16).sum(-1) @ min16.view(64, 32).T
    assert _rel(unrounded.numpy(), ref) > TOL["fast"]


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("fmt", FORMATS)
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
    assert _rel(got.numpy(), ref) <= TOL["high"]
    got = getattr(compat, f"mmq_{fmt}")(torch.from_numpy(raw),
                                        torch.from_numpy(b), m, n, k,
                                        device="cpu", act_quant=False)
    ref = getattr(jax_compat, f"mmq_{fmt}")(raw, b, m, n, k, act_quant=False)
    assert _rel(got.numpy(), ref) <= TOL["high"]


def test_operand_checks_and_launch_counters():
    _, _, w2 = _weight("q2_k", 16, 256, seed=7)
    _, _, w3 = _weight("q3_k", 16, 256, seed=7)
    with pytest.raises(ValueError):
        mmq_q2_k(w3, torch.zeros(2, 256))               # wrong format
    with pytest.raises(ValueError):
        mmq_q3_k(w2, torch.zeros(2, 256))
    with pytest.raises(ValueError):
        mmq_q2_k(w2, torch.zeros(2, 512))               # wrong K
    with pytest.raises(ValueError, match="precision"):
        mmq_q3_k(w3, torch.zeros(2, 256), precision="medium")
    before = (mmq_q2_k.launches, mmq_q3_k.launches)
    for fn, w in ((mmq_q2_k, w2), (mmq_q3_k, w3)):
        for kw in ({}, {"act_quant": True}, {"precision": "fast"}):
            assert fn(w, torch.ones(3, 256), **kw).shape == (3, 16)
    assert (mmq_q2_k.launches, mmq_q3_k.launches) == before
    assert MMQ["q2_k"] is mmq_q2_k and MMQ["q3_k"] is mmq_q3_k


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint64 arrays holding 32-bit words: result
    byte i is byte (s >> 4i) & 7 of y:x."""
    x, y, s = (np.asarray(v, np.uint64) for v in (x, y, s))
    xy = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((xy >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out


def _bytes_of(words):
    """(..., ) uint64 words -> (..., 4) uint8 bytes, little-endian."""
    return ((words[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64)))
            & np.uint64(0xFF)).astype(np.uint8)


def test_q3_k_tensor_core_decode_matches_dequantize():
    """K13's tensor-core tile (csrc/mmq_q3_k.cu: mmq_q3_k_tc), run in numpy:
    per chunk h of a superblock, k16 step k and lane t, K1's byte permute
    of the chunk's qs bytes and of the superblock's hmask bytes (the same
    words for both chunks), crumb k/2 and hmask bit 4h + k/2, the int8
    value q - 4 (0xFC ORed in where the bit is clear), and d * sc from the
    scale bytes decoded four at a time, give `QuantWeight.dequantize()`
    bit for bit at elements 16k + (2t, 2t+1, 2t+8, 2t+9) of the chunk."""
    m, k = 4, 512
    rng = np.random.default_rng(11)
    nb = k // 256
    raw = rng.integers(0, 256, (m, nb, 110), dtype=np.uint8)
    raw[:, :, 108:110] = rng.uniform(-1, 1, (m, nb, 1)).astype(
        np.float16).view(np.uint8)
    w = QuantWeight.from_blocks("q3_k", raw.reshape(m, -1), (m, k), "cpu")
    want = w.dequantize().numpy().reshape(m, nb, 2, 128)
    f = {n: t.numpy().reshape(m, nb, -1) for n, t in w.fields.items()}
    words = lambda b: b.copy().view(np.uint32).astype(np.uint64)
    qs, hm = words(f["qs"]), words(f["hmask"])             # (m, nb, 16), 8
    sc = words(f["scales"])                                  # (m, nb, 3)
    d = f["d"].copy().view(np.float16).astype(np.float32)[..., 0]
    for h in range(2):
        lo = [(sc[..., i] >> np.uint64(4 * h)) & np.uint64(0x0F0F0F0F)
              for i in (0, 1)]
        hi = [((sc[..., 2] >> np.uint64(4 * h + 2 * i)) & np.uint64(0x03030303))
              << np.uint64(4) for i in (0, 1)]
        scale = [d[..., None] * (_bytes_of(lo[i] | hi[i]).astype(np.float32)
                                 - np.float32(32)) for i in (0, 1)]
        scale = np.concatenate(scale, axis=-1)              # (m, nb, 8)
        for t in range(4):
            sel = 0x7632 if t & 1 else 0x5410
            for q in range(2):   # half q of the chunk's 32 bytes: words 4q..
                a, b = 4 * q + (t >> 1), 4 * q + (t >> 1) + 2
                v = _byte_perm(qs[..., 8 * h + a], qs[..., 8 * h + b], sel)
                hv = _byte_perm(hm[..., a], hm[..., b], sel)
                for kk in range(q, 8, 2):   # the k16 steps of half q
                    j = kk >> 1
                    crumbs = (v >> np.uint64(2 * j)) & np.uint64(0x03030303)
                    hbit = (hv >> np.uint64(4 * h + j)) & np.uint64(0x01010101)
                    val = crumbs | ((hbit ^ np.uint64(0x01010101))
                                    * np.uint64(0xFC))
                    got = scale[..., kk, None] * _bytes_of(val).view(
                        np.int8).astype(np.float32)
                    elems = 16 * kk + np.array([2 * t, 2 * t + 1, 2 * t + 8,
                                                2 * t + 9])
                    np.testing.assert_array_equal(got, want[:, :, h, elems])


class _FakeLib:
    """A C library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


# the Q2_K mix's Q3_K weights (wo, down) and a uniform Q3_K file's
# gate_up, wqkv and head at TinyLlama's widths
Q3_K_SHAPES = [(2048, 2048), (2048, 5632), (11264, 2048), (2560, 2048),
               (32000, 2048)]


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_q3_k_cuda_dispatch(monkeypatch, precision):
    """On a CUDA tensor K13 "fast" launches the tensor-core entry
    (mmq_q3_k_tc_launch) with `tc_plan`'s split at the TinyLlama shapes;
    "high" launches the SIMT entry (mmq_q3_k_launch) alone."""
    mod = importlib.import_module("gguf_tpu_torch.ops.mmq_q3_k")
    lib = _FakeLib()
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    for name in ("mmq_q4_k", "mmq_q8_0"):   # launch_tc's, launch_split_k's
        monkeypatch.setattr(importlib.import_module(f"gguf_tpu_torch.ops.{name}"),
                            "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    for m, k in Q3_K_SHAPES:
        w = QuantWeight.from_blocks(
            "q3_k", np.zeros((m, k // 256 * 110), np.uint8), (m, k), "cpu")
        for n in (1, 16, 512):
            for dtype in (torch.bfloat16, torch.float32):
                lib.calls.clear()
                out = mod._launch(w, torch.zeros((n, k), dtype=dtype),
                                  precision)
                assert out.shape == (n, m) and len(lib.calls) == 1
                name, args = lib.calls[0]
                x_bf16 = int(dtype == torch.bfloat16)
                if precision == "high":
                    assert name == "mmq_q3_k_launch"
                    assert args[7:11] == (m, n, k, x_bf16)
                    continue
                assert name == "mmq_q3_k_tc_launch"
                assert args[8:] == (m, n, k, x_bf16, *tc_plan(m, n, k, 132),
                                    None)
