"""K10 (`mmq_q8_0`) under "fast" on the bf16 tensor-core ring of
`csrc/block32_tc.cuh`, checked on the CPU: the wrapper's CUDA dispatch
(the tensor-core entry at every K that is a multiple of 32, ragged chunks
included, with `tc_plan`'s split; the SIMT entry under "high"), the C
entries' guards read from the source, the Q8_0 fragment map (two 32-bit
shared loads of the 128-byte-swizzled code box and one byte permute, the
selectors parsed from the source) run in numpy against direct indexing,
and the split plan pinned at the TinyLlama Q8_0 shapes. The kernel's
numbers are held against its plain version on the card by chip_smoke.py;
the plain version against the JAX package in test_torch_block32.py."""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from gguf_tpu_torch.ops import build
from gguf_tpu_torch.ops.mmq_q4_k import KH, split_k, tc_plan, tc_tile
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight

K10 = importlib.import_module("gguf_tpu_torch.ops.mmq_q8_0")


def _source(name):
    with open(os.path.join(build.CSRC_DIR, name)) as f:
        return f.read()


def _guard(source, entry):
    """The condition under which a C entry point refuses its arguments."""
    body = source[source.index(f'extern "C" int {entry}('):]
    return body[body.index("if ("):body.index("return static_cast<int>(cudaErrorInvalidValue)")]


class _FakeLib:
    """A C library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _weight(m, k, seed=0):
    rng = np.random.default_rng(seed)
    return QuantWeight.from_blocks(
        "q8_0", QUANTIZERS["q8_0"](rng.standard_normal((m, k))), (m, k), "cpu")


# TinyLlama's Q8_0 projections (wqkv, wo, gate_up, down) and head, and the
# ragged K of compat's sweep (one or two 128-element chunks, the last short)
SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
          (32000, 2048), (1, 32), (4, 64), (16, 96), (4, 160)]


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_cuda_dispatch(monkeypatch, precision):
    """On a CUDA tensor K10 "fast" launches the tensor-core entry
    (mmq_q8_0_tc_launch) with `tc_plan`'s split at every K a multiple of
    32, its d read 8 bytes at a time only when K % 128 == 0; "high"
    launches the SIMT entry (mmq_q8_0_launch) with fast = 0."""
    lib = _FakeLib()
    monkeypatch.setattr(K10, "_lib", lambda: lib)
    for name in ("mmq_q4_k", "mmq_q8_0"):   # launch_tc's, launch_split_k's
        monkeypatch.setattr(importlib.import_module(f"gguf_tpu_torch.ops.{name}"),
                            "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    for m, k in SHAPES:
        w = QuantWeight.from_blocks(
            "q8_0", np.zeros((m, k // 32 * 34), np.uint8), (m, k), "cpu")
        # fields of their own allocations, as on the card (a one-block row
        # is otherwise a view into the block bytes, 2 bytes in)
        w.fields = {name: f.clone() for name, f in w.fields.items()}
        for n in (1, 16, 512):
            for dtype in (torch.bfloat16, torch.float32):
                lib.calls.clear()
                out = K10._launch(w, torch.zeros((n, k), dtype=dtype), precision)
                assert out.shape == (n, m) and len(lib.calls) == 1
                name, args = lib.calls[0]
                x_bf16 = int(dtype == torch.bfloat16)
                if precision == "high":
                    assert name == "mmq_q8_0_launch"
                    assert args[5:] == (m, n, k, x_bf16, 0,
                                        *split_k(m, n, k, 132), None)
                    continue
                assert name == "mmq_q8_0_tc_launch"
                assert args[6:] == (m, n, k, x_bf16, *tc_plan(m, n, k, 132),
                                    None)


def test_c_entries_take_every_k_and_the_simt_one_refuses_fast():
    """The tensor-core entry takes any K that is a multiple of 32 (its
    chunk count rounded up), the SIMT entry refuses "fast": there is no
    path back to the SIMT tile under "fast"."""
    src = _source("mmq_q8_0.cu")
    tc = _guard(src, "mmq_q8_0_tc_launch")
    assert "K % 32 != 0" in tc and "K % 256" not in tc and "K % 128" not in tc
    assert "const int chunks = (K + tc::KH - 1) / tc::KH;" in src
    assert re.search(r"\|\| fast \|\|", _guard(src, "mmq_q8_0_launch"))
    # the tile walks the rounded-up chunk count too
    assert "min((K + KH - 1) / KH, c0 + chunks_per_split)" in _source("block32_tc.cuh")


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


def test_fragment_map_gives_each_lane_its_codes():
    """K10's A fragments (block32_tc.cuh: `codes` over the 128-byte
    swizzled box): for every row r of a 64-row box, lane (g = r % 8, t)
    and k16 step s, piece s ^ (r & 7) of the staged row, words t/2 and
    t/2 + 2 of it and the byte permute selected by t & 1 give the int8
    codes of elements 16s + 2t, 2t + 1, 2t + 8 and 2t + 9 of the row's
    128-element chunk, as the m16n8k16 A layout wants them (registers 0/1:
    k = 2t, 2t + 1; 2/3: k = 2t + 8, 2t + 9)."""
    tile = _source("block32_tc.cuh")
    sel = re.search(r"const uint32_t sel = \(t & 1\) \? (0x[0-9A-Fa-f]+)u : "
                    r"(0x[0-9A-Fa-f]+)u;", tile)
    odd, even = int(sel.group(1), 16), int(sel.group(2), 16)
    assert "const int sw = F::CODE == 64 ? (g >> 1) & 3 : g;" in tile
    assert "16 * (u ^ sw) + 4 * (t >> 1)" in tile
    k = 256
    w = _weight(64, k, seed=3)
    codes = w.fields["qs"].numpy().view(np.int8).reshape(64, k)
    for c in range(k // KH):
        chunk = codes[:, KH * c:KH * (c + 1)].view(np.uint8)
        # TMA's 128-byte swizzle: 16-byte piece u of row r lands at u ^ (r % 8)
        staged = np.zeros_like(chunk)
        for u in range(8):
            for r in range(64):
                staged[r, 16 * (u ^ (r % 8)):16 * (u ^ (r % 8)) + 16] = \
                    chunk[r, 16 * u:16 * u + 16]
        words = np.ascontiguousarray(staged).view(np.uint32).astype(np.uint64)
        for r in range(64):
            g = r % 8        # this row's lane group in its warp (rows g, g + 8)
            for t in range(4):
                for s in range(8):
                    base = 4 * (s ^ g) + (t >> 1)      # word index in the row
                    v = _byte_perm(words[r, base], words[r, base + 2],
                                   odd if t & 1 else even)
                    got = ((int(v) >> (8 * np.arange(4))) & 0xFF).astype(
                        np.uint8).view(np.int8)
                    elems = 16 * s + np.array([2 * t, 2 * t + 1, 2 * t + 8,
                                               2 * t + 9])
                    np.testing.assert_array_equal(
                        got, codes[r, KH * c + elems])


# (M, K, {n: tc_plan}) at TinyLlama's Q8_0 shapes and compat's ragged K
_PLANS = [
    (2560, 2048, {1: (6, 3), 16: (6, 3), 512: (4, 4)}),
    (2048, 2048, {1: (8, 2), 16: (8, 2), 512: (4, 4)}),
    (11264, 2048, {1: (2, 8), 16: (2, 8), 512: (1, 16)}),
    (2048, 5632, {1: (8, 6), 16: (8, 6), 512: (5, 9)}),
    (32000, 2048, {1: (1, 16), 16: (1, 16), 512: (1, 16)}),
    (1, 32, {1: (1, 1), 16: (1, 1), 512: (1, 1)}),
    (4, 160, {1: (2, 1), 16: (2, 1), 512: (2, 1)}),
]


@pytest.mark.parametrize("m,k,plans", _PLANS)
def test_split_plan_at_the_tinyllama_shapes(m, k, plans):
    """K10's wrapper splits K as K2 and K11-K14 do (`tc_plan`: 128-element
    chunks, 2 blocks per SM, a ragged last chunk counted whole): every
    split holds a chunk, as the C entry checks; the head stays whole."""
    chunks = -(-k // KH)
    for n, want in plans.items():
        splits, per = tc_plan(m, n, k, 132)
        assert (splits, per) == want
        assert want == split_k(m, n, k, 132, tc_tile(n), 2, KH)
        assert (splits - 1) * per < chunks <= splits * per
