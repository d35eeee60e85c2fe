"""K9 (`decode_attention_tiled`, csrc/attention_tiled.cu) as the card runs
it, checked on the CPU: its plan (`k9_plan`: CTAs per cluster) pinned at
the TinyLlama and Llama-2-7B shapes and at the long spans of Llama-3's
geometries, its shared-memory size mirrored from the source, one launch per
call with the plan's arguments (and the t = 1 insert fused in, no K3), and
its split re-enacted in plain torch (the live rows cut across the CTAs of a
cluster, each CTA's per-tile maxes merged into the reference's running max
m_t, p . v against m_t, the partials weighted by exp(m_t - M) and added in
row, warp and rank order; a slice longer than the rows held walked in
sub-slices, scored once for the tile maxes and again for p . v) and held
against `decode_attention_tiled_plain` and the JAX package's Pallas
`decode_attention_tiled` in interpret mode."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gguf_tpu.ops.attention import decode_attention_tiled as jax_tiled
from gguf_tpu_torch.ops import build
from gguf_tpu_torch.ops.attention import (K4_SMEM, K4_WARPS, K9_CHUNK, K9_GB,
                                          K9_MAX_CLUSTER, K9_SHARE,
                                          K9_STAGES, TILE,
                                          _tiled_cuda,
                                          decode_attention_tiled,
                                          decode_attention_tiled_plain,
                                          decode_attention_update, k9_plan,
                                          k9_smem_bytes,
                                          kv_cache_insert_plain, quantize_kv)

ATT = importlib.import_module("gguf_tpu_torch.ops.attention")
# f32 sums in another order, and under "fast" a rare bf16 rounding of
# p * v_scale flipped by it (tests/test_torch_attention.py's TILED_TOL is
# 1e-4 between the plain version and JAX; the card is held to 1e-3)
TOL = 1e-3
# (B, H, KVH, S, hd): GQA at TinyLlama's head geometry, MHA at Llama-2-7B's
GEOMETRIES = {"gqa": (4, 8, 2, 1024, 64), "mha": (3, 2, 2, 1024, 128)}


def _scores(qr, k, ks, hd, softcap):
    sc = qr @ k.float().T * (ks * (1.0 / hd ** 0.5))
    return softcap * torch.tanh(sc * (1.0 / softcap)) if softcap else sc


def _k9_reenacted(q, k, ks, v, vs, pos, *, precision, span, window=0,
                  softcap=0.0, clusters, held=None, k_new=None, v_new=None):
    """K9's arithmetic in torch, in the kernel's order: per (slot, KV head)
    the live rows [L0, L1) cut into `clusters` slices; scores per slice, or
    per sub-slice of `held` rows where the slice is longer (merging the
    sub-slices' tile maxes, and scoring each sub-slice again for p . v);
    each slice's max per 256-row tile, published as its whole max and its
    first tile's; m_t from the own prefix, every earlier rank's max and
    the first-tile max of a later rank starting in the tile; w = exp(m_t -
    M); pv = w * round(p * v_scale) and l = sum w * p per slice, p . v by
    warps over every K4_WARPS-th row; out = sum acc / sum l in rank order.
    With k_new/v_new the new rows are quantized first, row pos of the
    cache is written, and the slices read the copy. Returns (out, cache)."""
    b, h, _, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    dt = torch.bfloat16 if precision == "fast" else torch.float32
    k, ks, v, vs = (c.clone() for c in (k, ks, v, vs))
    if k_new is not None:
        qk, sk = quantize_kv(k_new.float())
        qv, sv = quantize_kv(v_new.float())
    qr = q.reshape(b, kvh, g, hd).to(dt).float()
    out = torch.zeros(b, kvh, g, hd)
    for bi in range(b):
        p0 = int(pos[bi])
        l1 = 0 if p0 < 0 else min(p0 + 1, span)
        l0 = max(0, p0 - window + 1) if window else 0
        per = -(-max(0, l1 - l0) // clusters)
        slices = [(l0 + r * per, max(0, min(l1, l0 + r * per + per)
                                     - l0 - r * per))
                  for r in range(clusters)]
        for hi in range(kvh):
            if k_new is not None and 0 <= p0 < s:
                k[bi, hi, p0], ks[bi, hi, p0] = qk[bi, hi, 0], sk[bi, hi, 0]
                v[bi, hi, p0], vs[bi, hi, p0] = qv[bi, hi, 0], sv[bi, hi, 0]
            parts = []
            for lo, n in slices:      # 1-2. scores; 3. the slice's tile maxes
                step = n if held is None or n <= held else held
                subs = [(a, min(n, a + step)) for a in range(0, n, step or 1)]
                tiles = (torch.arange(lo, lo + n) // TILE).tolist()
                tmax = {}
                for a, e in subs:
                    sc = _scores(qr[bi, hi], k[bi, hi, lo + a:lo + e],
                                 ks[bi, hi, lo + a:lo + e], hd, softcap)
                    for t in sorted(set(tiles[a:e])):
                        m = sc[:, [i for i in range(e - a)
                                   if tiles[a + i] == t]].amax(-1)
                        tmax[t] = torch.maximum(tmax[t], m) if t in tmax \
                            else m
                parts.append((lo, n, subs, tiles, tmax))
            none = torch.full((g,), -torch.inf)
            xm = [torch.stack(list(tm.values())).amax(0) if tm else none
                  for *_, tm in parts]
            xh = [next(iter(tm.values())) if tm else none
                  for *_, tm in parts]
            top = torch.stack(xm).amax(0)
            acc_r, l_r = [], []
            for r, (lo, n, subs, tiles, tmax) in enumerate(parts):
                mt, w = {}, {}
                for t in tmax:
                    m = torch.stack([tmax[u] for u in tmax if u <= t]).amax(0)
                    for o in range(clusters):
                        lo_o = slices[o][0]
                        if o < r:
                            m = torch.maximum(m, xm[o])
                        elif o > r and lo_o < l1 and lo_o // TILE <= t:
                            m = torch.maximum(m, xh[o])
                    mt[t], w[t] = m, torch.exp(m - top)
                acc = torch.zeros(g, hd)
                lsum = torch.zeros(g)
                for a, e in subs:     # 4. weighted pv and l; p . v by warps
                    sc = _scores(qr[bi, hi], k[bi, hi, lo + a:lo + e],
                                 ks[bi, hi, lo + a:lo + e], hd, softcap)
                    m_rows = torch.stack([mt[t] for t in tiles[a:e]], -1)
                    w_rows = torch.stack([w[t] for t in tiles[a:e]], -1)
                    p = torch.exp(sc - m_rows)
                    lsum = lsum + (w_rows * p).sum(-1)
                    pv = w_rows * (p * vs[bi, hi, lo + a:lo + e]).to(dt).float()
                    rows = torch.arange(a, e)
                    for wp in range(K4_WARPS):
                        sel = rows[rows % K4_WARPS == wp]
                        acc = acc + pv[:, sel - a] @ v[bi, hi, lo + sel].float()
                acc_r.append(acc)
                l_r.append(lsum)
            a = sum(acc_r[1:], acc_r[0])        # 5. rank order
            den = sum(l_r[1:], l_r[0])
            out[bi, hi] = torch.where(den[:, None] > 0, a / den[:, None],
                                      torch.zeros_like(a))
    return out.reshape(b, h, 1, hd), (k, ks, v, vs)


def _inputs(geometry, seed):
    b, h, kvh, s, hd = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (b, kvh, s, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (b, kvh, s, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (b, kvh, s)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (b, kvh, s)).astype(np.float32)
    q = (rng.standard_normal((b, h, 1, hd)) * 2).astype(np.float32)
    return q, k, ks, v, vs


def _positions(b, s, seed):
    """Batches of b positions holding 0, 255, 256, pos = S (an inactive
    slot: every column live) and random ones."""
    rng = np.random.default_rng(seed)
    want = [0, 255, 256, s] + list(rng.integers(1, s, 2 * b))
    return [np.array(want[i:i + b], np.int32)
            for i in range(0, len(want) - b + 1, b)]


def _close(got, ref, what):
    ref = np.asarray(ref)
    if not ref.size:      # no slot with a live column in this batch
        return
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err <= TOL * np.max(np.abs(ref)), (what, err, np.max(np.abs(ref)))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 8.0)])
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_split_matches_plain_and_jax(geometry, precision, window, softcap):
    """The re-enacted kernel at its plan and at cluster sizes whose slices
    do not align to the 256-row tiles (3, 5, 8), and walking sub-slices of
    64-192 rows, over spans 1024 and 512, against the plain version and the
    JAX kernel at every position. With
    a window, a slot at pos = S over span 512 has no live column: the
    reference leaves its row undefined (its online softmax averages the
    masked tiles), the kernel gives 0; that slot is held to 0 alone."""
    b, h, kvh, s, hd = GEOMETRIES[geometry]
    q, k, ks, v, vs = _inputs(geometry, seed=hd + int(window))
    tq, tk, tks, tv, tvs = (torch.from_numpy(a) for a in (q, k, ks, v, vs))
    for span in (s, s // 2):
        kw = dict(precision=precision, span=span, window=window,
                  softcap=softcap)
        plan = k9_plan(b, kvh, h // kvh, span, hd, 132)[0]
        for pos in _positions(b, s, seed=span + hd):
            tpos = torch.from_numpy(pos)
            live = torch.from_numpy(
                (pos < span) | (window == 0) | (pos - window + 1 < span))
            plain = decode_attention_tiled_plain(tq, tk, tks, tv, tvs, tpos,
                                                 **kw)[live]
            ref = np.asarray(jax_tiled(*(jnp.asarray(a) for a in
                                         (q, k, ks, v, vs, pos)),
                                       **kw))[live.numpy()]
            _close(plain, ref, "plain vs jax")
            splits = [(c, None) for c in sorted({plan, 1, 3, 5, 8})]
            for clusters, held in splits + [(1, 128), (3, 64), (2, 192)]:
                got, _ = _k9_reenacted(tq, tk, tks, tv, tvs, tpos,
                                       clusters=clusters, held=held, **kw)
                what = f"C={clusters} held={held} span={span}"
                assert not got[~live].any()
                _close(got[live], plain, f"{what} vs plain")
                _close(got[live], ref, f"{what} vs jax")


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fused_insert_matches_insert_then_plain(geometry, precision):
    """With the new rows the cache comes out bit-equal to K3's plain
    insert (an inactive slot at pos = S writes nothing) and the output
    matches the insert followed by the tiled plain version."""
    b, h, kvh, s, hd = GEOMETRIES[geometry]
    q, k, ks, v, vs = _inputs(geometry, seed=3 * hd)
    rng = np.random.default_rng(hd)
    kn = torch.from_numpy((rng.standard_normal((b, kvh, 1, hd)) * 2)
                          .astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((b, kvh, 1, hd))
                          .astype(np.float32))
    kn[0, 0, 0] = 0.0          # an all-zero row quantizes with scale 0
    tq = torch.from_numpy(q)
    for pos in _positions(b, s, seed=7):
        tpos = torch.from_numpy(pos)
        ref_cache = [torch.from_numpy(a.copy()) for a in (k, ks, v, vs)]
        kv_cache_insert_plain(kn, vn, *ref_cache, tpos)
        kw = dict(precision=precision, span=s)
        ref = decode_attention_tiled_plain(tq, *ref_cache, tpos, **kw)
        plan = k9_plan(b, kvh, h // kvh, s, hd, 132)[0]
        for clusters, held in ((plan, None), (3, None), (2, 128)):
            got, cache = _k9_reenacted(
                tq, *(torch.from_numpy(a) for a in (k, ks, v, vs)), tpos,
                clusters=clusters, held=held, k_new=kn, v_new=vn, **kw)
            for g, r in zip(cache, ref_cache):
                assert torch.equal(g, r)
            _close(got, ref, f"C={clusters} held={held} insert")


_SHAPES = {"tinyllama": (4, 8, 64), "7b": (32, 1, 128)}
# (model, slots) -> k9_plan at spans 1024, 2048, 4096 on 132 SMs
_PLANS = {("7b", 16): [1, 2, 2], ("7b", 1): [8, 8, 8],
          ("tinyllama", 16): [4, 4, 4], ("tinyllama", 1): [8, 8, 8]}


@pytest.mark.parametrize("span", [1024, 2048, 4096])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("model", sorted(_SHAPES))
def test_plan(model, b, span):
    """Llama-2-7B's 512 (slot, KV head) clusters at 16 slots take one CTA
    at span 1024 and two above (slices of at most 1024 rows, but no more
    than 2 CTAs for that); at one slot (32 clusters) 8 CTAs each, the
    most a cluster takes, and TinyLlama's 64 take 4 and its 4 take 8, to
    cover the 132 SMs. Every plan holds its whole slice of scores in
    shared memory."""
    kvh, g, hd = _SHAPES[model]
    clusters = _PLANS[model, b][[1024, 2048, 4096].index(span)]
    rows = -(-span // clusters)
    assert k9_plan(b, kvh, g, span, hd, 132) == (clusters, rows)
    assert k9_smem_bytes(g, rows, hd) <= K4_SMEM


# (slots, KVH, G, span, hd) -> (clusters, rows held): the spans of
# Llama-3.1-8B (G = 4, hd 128), Llama-3-70B (G = 8) and Llama-3.2-1B (G = 4,
# hd 64) up to their 131,072-row context, and Llama-2-7B's geometry there
_LONG = {(16, 8, 4, 32768, 128): (8, 4096), (16, 8, 4, 65536, 128): (8, 2112),
         (16, 8, 4, 131072, 128): (8, 2048), (1, 8, 8, 131072, 128): (8, 1024),
         (16, 8, 4, 131072, 64): (8, 3328), (1, 32, 1, 131072, 128): (8, 16384),
         (1, 32, 1, 262144, 128): (8, 6976), (1, 1, 96, 4096, 128): (8, 128)}


@pytest.mark.parametrize("shape", sorted(_LONG))
def test_plan_takes_long_spans(shape):
    """Past what a slice's scores can hold, the plan keeps 8 CTAs and holds
    the most rows, a multiple of the 64-row stage, that let two CTAs share
    an SM (or, where not even one stage does, that fit at all): the kernel
    walks the slice in sub-slices of them; every span is taken."""
    b, kvh, g, span, hd = shape
    clusters, held = k9_plan(b, kvh, g, span, hd, 132)
    assert (clusters, held) == _LONG[shape]
    rows = -(-span // clusters)
    assert held == rows or held % K9_CHUNK == 0
    assert k9_smem_bytes(g, rows, hd, held) <= K4_SMEM
    if held < rows:
        limit = (K9_SHARE if k9_smem_bytes(g, rows, hd, held) <= K9_SHARE
                 else K4_SMEM)
        assert k9_smem_bytes(g, rows, hd, held + K9_CHUNK) > limit


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_sub_slices_at_llama3_8b_span(precision):
    """Llama-3.1-8B's geometry (4 query heads of 128 per KV head) at span
    65,536, where each of the 8 CTAs' 8,192-row slices is walked in
    sub-slices of the plan's 2,112 rows: the re-enacted kernel against the
    plain version, at a slot ending in the first sub-slice, one across
    both, the last row, an inactive slot (every row live), and with a
    60,000-row window and softcap 30."""
    b, g, hd, span = 4, 4, 128, 65536
    clusters, held = k9_plan(16, 8, g, span, hd, 132)
    assert held < -(-span // clusters)
    rng = np.random.default_rng(span)
    k = torch.from_numpy(rng.integers(-127, 128, (b, 1, span, hd), np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (b, 1, span, hd), np.int8))
    ks = torch.from_numpy(rng.uniform(0.001, 0.02, (b, 1, span))
                          .astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.001, 0.02, (b, 1, span))
                          .astype(np.float32))
    q = torch.from_numpy((rng.standard_normal((b, g, 1, hd)) * 2)
                         .astype(np.float32))
    pos = torch.tensor([5000, 12000, span - 1, span], dtype=torch.int32)
    for window, softcap in ((0, 0.0), (60000, 30.0)):
        kw = dict(precision=precision, span=span, window=window,
                  softcap=softcap)
        plain = decode_attention_tiled_plain(q, k, ks, v, vs, pos, **kw)
        got, _ = _k9_reenacted(q, k, ks, v, vs, pos, clusters=clusters,
                               held=held, **kw)
        _close(got, plain, f"window={window} held={held}")


def test_smem_bytes_mirror_the_kernel():
    """`k9_smem_bytes` is csrc/attention_tiled.cu's TiledSmem total,
    evaluated from the source's initializer list and constants."""
    with open(os.path.join(build.CSRC_DIR, "attention_tiled.cu")) as f:
        src = f.read()
    consts = dict((n, int(v)) for n, v in
                  re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (consts["NS"], consts["CH"], consts["GB"], consts["MAXC"]) == (
        K9_STAGES, K9_CHUNK, K9_GB, K9_MAX_CLUSTER)
    assert consts["NTHREADS"] // 32 == K4_WARPS
    body = src[src.index("struct TiledSmem {"):]
    inits = body[body.index(": stage(0)") + 1:body.index("{}")]
    for g, rows, hd, held in ((1, 512, 128, 512), (8, 256, 64, 256),
                              (8, 1024, 64, 1024), (16, 512, 128, 512),
                              (3, 37, 64, 37), (4, 8192, 128, 6976),
                              (8, 16384, 128, 3968)):
        env = {"G": g, "HD": hd, "RB": 1 if g == 1 else K9_GB, "held": held,
               "ntl": rows // TILE + 2, "NS": K9_STAGES, "CH": K9_CHUNK,
               "MAXC": K9_MAX_CLUSTER,
               "WARPS": K4_WARPS, "up4": lambda n: (n + 3) & ~3}
        for name, expr in re.findall(r"(\w+)\(([^()]*(?:\([^()]*\)[^()]*)*)\)",
                                     inits):
            env[name] = eval(expr.replace("/", "//"), env)
        assert env["total"] == k9_smem_bytes(g, rows, hd, held)


class _FakeLib:
    """A C library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ATT, "_lib", lambda: lib)
    monkeypatch.setattr(ATT, "_lib_tiled", lambda: lib)
    monkeypatch.setattr(ATT, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    return lib


@pytest.mark.parametrize("model,insert", [
    ("tinyllama", False), ("tinyllama", True), ("7b", False), ("7b", True)])
def test_one_launch_with_the_plan(monkeypatch, model, insert):
    """Each K9 call is one launch of decode_attention_tiled_launch carrying
    the plan's cluster size, the slice bound ceil(span / C), the rows held
    and the flags (bit 1: the fused insert)."""
    lib = _fake_card(monkeypatch)
    kvh, g, hd = _SHAPES[model]
    b, s, span = 2, 4096, 2048
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    q = torch.zeros((b, kvh * g, 1, hd))
    new = torch.zeros((b, kvh, 1, hd)) if insert else None
    before = decode_attention_tiled.launches
    out = _tiled_cuda(q, new, new, k, sc, k.clone(), sc.clone(),
                      torch.zeros(b, dtype=torch.int32), precision="fast",
                      span=span, window=0, softcap=0.0)
    assert out.shape == q.shape
    assert decode_attention_tiled.launches == before + 1
    assert [name for name, _ in lib.calls] == ["decode_attention_tiled_launch"]
    args = lib.calls[0][1]
    clusters, held = k9_plan(b, kvh, g, span, hd, 132)
    assert args[9:15] == (b, kvh, g, s, span, hd)
    assert args[17:] == (0, 1 | (2 if insert else 0), clusters,
                         -(-span // clusters), held, None)


def test_a_step_past_the_envelope_is_one_k9_launch(monkeypatch):
    """On a (fake) card a t = 1 step past the single-tile envelope, as
    `models/llama.py:attention` makes it through `decode_attention_update`,
    launches K9 once with the insert flag and no K3 or K4."""
    lib = _fake_card(monkeypatch)
    monkeypatch.setattr(ATT, "_on_card", lambda x: True)
    k3 = []
    monkeypatch.setattr(ATT, "kv_cache_insert", lambda *a: k3.append(a))
    b, kvh, hd, s = 2, 32, 128, 1024        # 32 * 1024 * 128 > 2^21
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    new = torch.zeros((b, kvh, 1, hd))
    launches = (ATT.decode_attention.launches,
                decode_attention_tiled.launches)
    out, *cache = decode_attention_update(
        torch.zeros((b, kvh, 1, hd)), new, new, k, sc, k.clone(), sc.clone(),
        torch.tensor([700, 1023], dtype=torch.int32), t=1, span=s)
    assert out.shape == (b, kvh, 1, hd) and cache[0] is k
    assert [name for name, _ in lib.calls] == ["decode_attention_tiled_launch"]
    assert lib.calls[0][1][18] & 2           # the insert flag
    assert not k3
    assert ATT.decode_attention.launches == launches[0]
    assert decode_attention_tiled.launches == launches[1] + 1


@pytest.mark.parametrize("g,s", [(4, 65536), (96, 4096)])
def test_long_slices_launch_with_sub_slices(monkeypatch, g, s):
    """A slice whose scores outgrow shared memory (Llama-3.1-8B's G = 4 at
    span 65,536; 96 query heads per KV head at 4,096) is one launch whose
    rows held are fewer than the slice's: the kernel walks it."""
    lib = _fake_card(monkeypatch)
    b, kvh, hd = 1, 1, 128
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    q = torch.zeros((b, g, 1, hd))
    _tiled_cuda(q, None, None, k, sc, k.clone(), sc.clone(),
                torch.zeros(b, dtype=torch.int32), precision="fast", span=s,
                window=0, softcap=0.0)
    (name, args), = lib.calls
    clusters, rows, held = args[19:22]
    assert (clusters, rows) == (8, s // 8) and K9_CHUNK <= held < rows
    assert held % K9_CHUNK == 0
    assert k9_smem_bytes(g, rows, hd, held) <= K4_SMEM


def test_refuses_what_shared_memory_cannot_hold(monkeypatch):
    """192 query rows of 128 per KV head: the query, the outputs and the
    warps' partials alone outgrow shared memory beside one 64-row
    sub-slice, and the wrapper refuses before any launch."""
    lib = _fake_card(monkeypatch)
    b, kvh, g, hd, s = 1, 1, 192, 128, 4096
    assert k9_smem_bytes(g, s // 8, hd, K9_CHUNK) > K4_SMEM
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    with pytest.raises(ValueError, match="shared memory"):
        _tiled_cuda(torch.zeros((b, g, 1, hd)), None, None, k, sc, k.clone(),
                    sc.clone(), torch.zeros(b, dtype=torch.int32),
                    precision="fast", span=s, window=0, softcap=0.0)
    assert not lib.calls
