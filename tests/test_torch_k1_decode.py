"""K1's decode tile (`csrc/kquant_dec.cuh`, "fast" at n <= 16): its work
plan on the CPU, and the kernel on the card.

On the CPU: `k1_decode_items` cuts every (row tile, superblock) unit of
Mistral-7B's and Mixtral-8x7B's Q4_K projections exactly once, in equal
shares, with distinct scratch slots for the segments the kernel adds up,
and the kernel's owner formula finds each segment's block; the exactness
on which its cheaper dequantize rests holds for every fp16 d and 6-bit
scale.

The `card` tests hold the tile on a CUDA device at n = 1, 8 and 16 and
the served shapes: one-hot activation rows give the plain dequantize's
bf16 weights bit for bit, outputs match `mmq_q4_k_plain` under "fast"
(with and without the GLU), two runs give equal bits, a call launches the
decode tile and no `add_splits`, and an 8-step decode chunk's replay
equals its eager run, with `decode_launches` counting every K1 launch of
the eager chunk. This file imports no jax, so they run there without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_k1_decode.py
"""

import numpy as np
import pytest
import torch

from gguf_tpu_torch.ops import mmq_q4_k
from gguf_tpu_torch.ops.mmq_q4_k import (DEC_ROWS, SB, dec_tile,
                                         k1_decode_items, k1_decode_plan,
                                         mmq_q4_k_plain)
from gguf_tpu_torch.quant import QuantWeight

# (M, K) of the Q4_K projections K1 runs at n = 16 in the served cells:
# Mistral-7B's wq / wo, wk (layers whose wv is Q6_K), wqkv, gate_up and
# down; Mixtral-8x7B's attn_q and each expert's gate_up and down are the
# same shapes
SERVED = [(4096, 4096), (1024, 4096), (6144, 4096), (28672, 4096),
          (4096, 14336)]
# TinyLlama's and the card tests' model, and a ragged M
SMALL = [(2560, 2048), (11264, 2048), (2048, 5632), (256, 2048), (1000, 512)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k", SERVED + SMALL)
def test_decode_plan_covers_every_unit_once(m, k, sms):
    """Every (row tile, superblock) unit in exactly one block's range,
    blocks' shares within one unit of each other, each partial segment's
    scratch slot b + t distinct and inside the (blocks + tiles - 1) slots
    the wrapper allocates."""
    blocks, tiles, sbs = k1_decode_plan(m, k, sms)
    assert (tiles, sbs) == (-(-m // DEC_ROWS), k // SB)
    assert blocks == min(sms, tiles * sbs)
    items = k1_decode_items(m, k, sms)
    seen = np.zeros((tiles, sbs), np.int64)
    shares, slots = [], set()
    for b, segs in enumerate(items):
        shares.append(sum(hi - lo for _, lo, hi in segs))
        for t, lo, hi in segs:
            assert 0 <= lo < hi <= sbs
            seen[t, lo:hi] += 1
            if hi - lo < sbs:
                assert b + t not in slots
                slots.add(b + t)
        assert [t for t, _, _ in segs] == sorted({t for t, _, _ in segs})
    assert (seen == 1).all()
    assert max(shares) - min(shares) <= 1
    assert all(0 <= s < blocks + tiles - 1 for s in slots)


@pytest.mark.parametrize("m,k", SERVED + SMALL)
def test_kernel_owner_formula_finds_each_segment(m, k):
    """The kernel's owner(u) = ((u + 1) G - 1) // W is the block whose
    range holds unit u, so the first and last segment of a tile, whose
    blocks bound the sum in block order, are the plan's."""
    blocks, tiles, sbs = k1_decode_plan(m, k, 132)
    units = tiles * sbs
    items = k1_decode_items(m, k, 132)
    owner = np.empty(units, np.int64)
    for b, segs in enumerate(items):
        for t, lo, hi in segs:
            owner[t * sbs + lo:t * sbs + hi] = b
    u = np.arange(units)
    np.testing.assert_array_equal(((u + 1) * blocks - 1) // units, owner)


def test_decode_tile_widths():
    """Two consumer warpgroups of 64 rows; 8 activation rows up to n = 8,
    16 up to n = 16."""
    assert [dec_tile(n) for n in (1, 8, 9, 16)] == [
        (128, 8), (128, 8), (128, 16), (128, 16)]


def test_scale_products_exact_for_every_fp16_d():
    """d*sc is exact in f32 with at most 17 significant bits for every
    finite fp16 d and every 6-bit scale, so (d*sc)*q is exact for q < 16
    and fmaf(d*sc, q, -dmin*mn) rounds where the codec's fmul-then-fsub
    does: the decode tile's weights are the codec's."""
    d = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    d = d[np.isfinite(d)].astype(np.float32)
    sc = np.arange(64, dtype=np.float32)
    s32 = d[:, None] * sc[None, :]
    np.testing.assert_array_equal(s32.astype(np.float64),
                                  d.astype(np.float64)[:, None] * sc)
    frac, _ = np.frexp(np.abs(s32[s32 != 0]).astype(np.float64))
    assert (frac * 2.0 ** 17 == np.round(frac * 2.0 ** 17)).all()


def test_subnormal_codes_give_the_codec_weights():
    """The tile's dequantize in numpy's f32 (subnormals kept): a code
    masked in place at bits p..p+3 is the float q 2^(p - 149); times
    d*sc 2^(105 - p) (exact) less dmin*mn 2^-44, then times 2^44, equals
    the codec's (d*sc)*q - dmin*mn bit for bit, for every code and
    position, at fp16 d and dmin from the smallest subnormal to 65504."""
    hv = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    hv = hv[np.isfinite(hv)].astype(np.float32)
    d = np.concatenate([hv[::61], hv[:64], hv[-64:]])
    dmin = np.random.default_rng(1).permutation(d)
    q = np.arange(16, dtype=np.uint32)[:, None]
    for sc, mn in [(0, 0), (1, 63), (37, 29), (63, 1), (63, 63)]:
        ref = (d * np.float32(sc)) * q.astype(np.float32) - dmin * np.float32(mn)
        for p in (0, 4, 8, 12):
            qs = (q << p).view(np.float32)
            s1 = (d * np.float32(2.0 ** (105 - p))) * np.float32(sc)
            z1 = (dmin * np.float32(2.0 ** -44)) * np.float32(mn)
            got = (s1 * qs - z1) * np.float32(2.0 ** 44)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32))


def test_cpu_tensors_never_count_decode_launches():
    m, k = 256, 512
    rng = np.random.default_rng(5)
    w = QuantWeight.from_blocks(
        "q4_k", rng.integers(0, 256, (m, k // 256 * 144), np.uint8), (m, k),
        "cpu")
    before = (mmq_q4_k.launches, mmq_q4_k.decode_launches)
    mmq_q4_k(w, torch.zeros(16, k), precision="fast")
    assert (mmq_q4_k.launches, mmq_q4_k.decode_launches) == before


# --------------------------------------------------------- on the card ---

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("runs K1's decode tile on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(m: int, k: int, seed: int) -> QuantWeight:
    """Random Q4_K blocks on the card: uniform codes, scales and mins, d
    and dmin fp16 of both signs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = torch.empty((m, k // SB, 144), dtype=torch.uint8, device="cuda")
    blocks.random_(0, 256, generator=gen)
    dd = (torch.rand((m, k // SB, 2), generator=gen, device="cuda") - 0.5) * 4e-3
    blocks[:, :, :4] = dd.half().view(torch.uint8)
    return QuantWeight("q4_k", (m, k), {"blocks": blocks.view(m, -1)})


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("m,k", SERVED[:3] + [(4096, 14336), (1000, 512)])
def test_one_hot_rows_give_the_plain_weights_bit_for_bit(cuda, m, k, n):
    """x = e_k rows: each output row is column k of the weight as the
    plain dequantize gives it, rounded to bf16, bit for bit; the columns
    cover every position of a superblock and superblocks across K."""
    w = _weight(m, k, seed=m + k)
    ref = w.dequantize().bfloat16().float()
    cols = (torch.arange(SB, device="cuda") * 37) % SB + \
        SB * (torch.arange(SB, device="cuda") % (k // SB))
    for lo in range(0, SB, n):
        c = cols[lo:lo + n]
        x = torch.zeros((len(c), k), dtype=torch.bfloat16, device="cuda")
        x[torch.arange(len(c)), c] = 1
        got = mmq_q4_k(w, x, precision="fast")
        assert torch.equal(got, ref[:, c].T), (lo, c.tolist())


@pytest.mark.card
@pytest.mark.parametrize("glu", [None, "silu"])
@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("m,k", SERVED + [(1000, 512)])
def test_decode_tile_matches_plain_and_repeats(cuda, m, k, n, glu):
    """Within "fast"'s 1e-3 of max|ref| of `mmq_q4_k_plain`, and two runs
    bit-equal; one decode-tile launch counted per call."""
    w = _weight(m, k, seed=3 * m + k)
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((n, 2 * k if glu else k), generator=gen,
                    device="cuda").bfloat16()
    before = (mmq_q4_k.launches, mmq_q4_k.decode_launches)
    got = mmq_q4_k(w, x, precision="fast", glu=glu)
    again = mmq_q4_k(w, x, precision="fast", glu=glu)
    assert (mmq_q4_k.launches, mmq_q4_k.decode_launches) == (
        before[0] + 2, before[1] + 2)
    ref = mmq_q4_k_plain(w, x, precision="fast", glu=glu)
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()), err
    assert torch.equal(got, again)


@pytest.mark.card
@pytest.mark.parametrize("n", [8, 16, 17])
def test_a_call_launches_the_decode_tile_and_no_split_sum(cuda, n):
    """By the profiler's kernel names: at n <= 16 a call runs K1's decode
    tile and no add_splits; at n = 17 the tensor-core tile, split."""
    w = _weight(4096, 4096, seed=1)
    x = torch.randn((n, 4096), device="cuda").bfloat16()
    mmq_q4_k(w, x, precision="fast")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        mmq_q4_k(w, x, precision="fast")
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA"]
    dec = [k for k in names if "mmq_q4_k_dec" in k]
    split = [k for k in names if "add_splits" in k]
    if n <= 16:
        assert len(dec) == 1 and not split, names
    else:
        assert not dec and split, names


@pytest.mark.card
def test_decode_chunk_replay_equals_eager_and_counts(cuda, tmp_path):
    """Two Q4_K layers (every projection K1: wqkv, wo, gate_up, down with
    the GLU), 16 slots: an eager 8-step decode chunk launches K1 only on
    its decode tile (decode_launches == launches), and the replayed
    graph's ids and cache equal the eager loop's."""
    from gguf_tpu_torch.engine import LLM, SamplerConfig
    from gguf_tpu_torch.models import LlamaConfig, write_random_llama_gguf

    cfg = LlamaConfig(vocab_size=4096, dim=1024, n_layers=2, n_heads=8,
                      n_kv_heads=2, ffn_dim=2816, max_seq_len=2048)
    path = str(tmp_path / "two_layers.gguf")
    write_random_llama_gguf(path, cfg, seed=2)
    llm = LLM(path, max_batch=16, max_seq=2048, device="cuda")
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, 16),
                             device="cuda")
    pos = torch.as_tensor(rng.integers(0, 1500, 16), device="cuda")
    saved = [{nm: c.clone() for nm, c in layer.items()} for layer in llm.cache]
    before = (mmq_q4_k.launches, mmq_q4_k.decode_launches)
    eager = llm._decode_eager(tokens, pos, SamplerConfig(), 8, 2048,
                              llm.generator).cpu().numpy()
    launched = (mmq_q4_k.launches - before[0],
                mmq_q4_k.decode_launches - before[1])
    assert launched == (8 * 2 * 4, 8 * 2 * 4), launched
    eager_cache = [{nm: c.clone() for nm, c in layer.items()}
                   for layer in llm.cache]
    for _ in range(2):              # the capture, then a replay
        for layer, old in zip(llm.cache, saved):
            for nm, c in layer.items():
                c.copy_(old[nm])
        chunk = llm._decode(tokens.cpu().numpy(), pos.cpu().numpy(),
                            SamplerConfig(), 8, 2048, llm.generator)
        assert np.array_equal(chunk.ids, eager) and chunk.finite
        assert all(torch.equal(c, r[nm]) for layer, r in
                   zip(llm.cache, eager_cache) for nm, c in layer.items())
