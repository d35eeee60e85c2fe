"""The plain version of K11 (`mmq_q4_0` .. `mmq_q5_1`) held against the
JAX package's `mmq_legacy` (Pallas in interpret mode on the CPU) and the
byte-level goldens, including the reference's split "fast" product and
its fp16 block sums under act_quant; the tensor-core tile's code decode
run in numpy, and the wrappers' CUDA dispatch pinned."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gguf_tpu.ops as jax_ops
import gguf_tpu.quant as jax_quant
from gguf_tpu.quant import quantize_q8_1
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err
from gguf_tpu_torch.ops import MMQ, build, mmq_legacy
from gguf_tpu_torch.ops.mmq_legacy import mmq_legacy_plain
from gguf_tpu_torch.ops.mmq_q4_k import tc_plan
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight
from gguf_tpu_torch.quant.layouts import BLOCK_BYTES, legacy_parts

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


def _constants(source, pattern):
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        return {k: int(v, 16) for k, v in re.findall(pattern, f.read())}


def _legacy_blocks(fmt, rows):
    """(rows, 8 blocks) of `fmt` whose first 32 blocks give element j of
    block i the code (i + j) mod 2^bits, so every element takes every code
    (and qh every bit at every position), and random bytes after."""
    bits, nb = (5 if fmt.startswith("q5") else 4), rows * 8
    rng = np.random.default_rng(LEGACY.index(fmt))
    codes = rng.integers(0, 1 << bits, (nb, 32))
    codes[:32] = (np.arange(32)[:, None] + np.arange(32)[None, :]) % (1 << bits)
    qs = ((codes[:, :16] & 15) | ((codes[:, 16:] & 15) << 4)).astype(np.uint8)
    parts = [rng.uniform(0.01, 1, (nb, 1)).astype(np.float16).view(np.uint8)]
    if fmt.endswith("_1"):
        parts.append(rng.uniform(-1, 1, (nb, 1)).astype(np.float16)
                     .view(np.uint8))
    if bits == 5:
        qh = ((codes >> 4) << np.arange(32)).sum(axis=1).astype(np.uint32)
        parts.append(qh[:, None].view(np.uint8))
    return np.concatenate(parts + [qs], axis=1).reshape(rows, -1)


@pytest.mark.parametrize("fmt", LEGACY)
def test_tensor_core_code_decode_gives_the_raw_codes(fmt):
    """K11's tensor-core policy (csrc/mmq_legacy.cu: Legacy::values), run in
    numpy with its selector constants parsed from the source: per lane t,
    K1's byte permute of a block's 16 qs bytes (block32_tc.cuh), the low
    and high nibbles, and for Q5_0/Q5_1 the lane's qh bits spread onto
    bit 4 by two byte permutes, give the raw codes `legacy_parts` holds
    for elements 2t, 2t+1, 2t+8, 2t+9 (low) and 16 more (high), over every
    code at every element of a block and random blocks."""
    qh_sel = _constants("mmq_legacy.cu",
                        r"constexpr uint32_t LEGACY_QH_(\w+) = (0x[0-9A-Fa-f]+)u;")
    lane_sel = _constants("block32_tc.cuh",
                          r"const uint32_t (sel) = \(t & 1\) \? (0x[0-9A-Fa-f]+)u")
    assert sorted(qh_sel) == ["HI", "LO"] and lane_sel == {"sel": 0x7632}
    rows = 8
    w = QuantWeight.from_blocks(fmt, _legacy_blocks(fmt, rows), (rows, 256),
                                "cpu")
    _, _, q = legacy_parts(w)
    want = q.numpy().astype(np.int64).reshape(-1, 32)
    qs = w.fields["qs"].numpy().reshape(-1, 16)
    words = qs.view(np.uint32).astype(np.uint64)            # (blocks, 4)
    qh = (w.fields["qh"].numpy().reshape(-1, 4).view(np.uint32)[:, 0]
          .astype(np.uint64) if "qh" in w.fields else None)
    m8 = np.uint64(0x01010101)
    for t in range(4):
        sel = 0x7632 if t & 1 else 0x5410
        v = _byte_perm(words[:, t >> 1], words[:, (t >> 1) + 2], sel)
        lo = v & np.uint64(0x0F0F0F0F)
        hi = (v >> np.uint64(4)) & np.uint64(0x0F0F0F0F)
        if qh is not None:
            h = qh >> np.uint64(2 * t)
            lo |= (_byte_perm(h, h >> np.uint64(1), qh_sel["LO"]) & m8) << np.uint64(4)
            hi |= (_byte_perm(h, h >> np.uint64(1), qh_sel["HI"]) & m8) << np.uint64(4)
        elems = np.array([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9])
        for word, off in ((lo, 0), (hi, 16)):
            got = (word[:, None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))
                   ) & np.uint64(0xFF)
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want[:, elems + off])


class _FakeLib:
    """A C library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _fake_cuda(monkeypatch, module):
    """Run a wrapper's CUDA dispatch on CPU tensors: its library records
    the launches, the card has 132 SMs, there is no stream."""
    lib = _FakeLib()
    monkeypatch.setattr(module, "_lib", lambda: lib)
    for name in ("mmq_q4_k", "mmq_q8_0"):   # launch_tc's, launch_split_k's
        monkeypatch.setattr(importlib.import_module(f"gguf_tpu_torch.ops.{name}"),
                            "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    return lib


def _zero_weight(fmt, m, k):
    return QuantWeight.from_blocks(
        fmt, np.zeros((m, k // 32 * BLOCK_BYTES[fmt]), np.uint8), (m, k), "cpu")


# TinyLlama's projections (wqkv, wo, gate_up, down) and head
TINYLLAMA_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
                    (32000, 2048)]


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("fmt", LEGACY)
def test_cuda_dispatch(monkeypatch, fmt, precision):
    """On a CUDA tensor K11 "fast" launches the tensor-core entry
    (mmq_legacy_tc_launch) with `tc_plan`'s split at the TinyLlama shapes,
    its format code, and block-sum scratch only for an f32 operand (a bf16
    one is summed from the staged tile); "high" launches the SIMT entry
    (mmq_legacy_launch) alone."""
    mod = importlib.import_module("gguf_tpu_torch.ops.mmq_legacy")
    lib = _fake_cuda(monkeypatch, mod)
    for m, k in TINYLLAMA_SHAPES:
        w = _zero_weight(fmt, m, k)
        for n in (1, 16, 512):
            for dtype in (torch.bfloat16, torch.float32):
                lib.calls.clear()
                out = mod._launch(w, torch.zeros((n, k), dtype=dtype),
                                  precision, dtype == torch.float32)
                assert out.shape == (n, m) and len(lib.calls) == 1
                name, args = lib.calls[0]
                fp16 = int(dtype == torch.float32)
                if precision == "high":
                    assert name == "mmq_legacy_launch"
                    assert args[7:9] == (mod.FMT_CODES[fmt], fp16)
                    continue
                assert name == "mmq_legacy_tc_launch"
                assert (args[6] is None) == (dtype == torch.bfloat16)
                assert args[9:] == (mod.FMT_CODES[fmt], fp16, m, n, k,
                                    int(dtype == torch.bfloat16),
                                    *tc_plan(m, n, k, 132), None)
