"""K4 (`decode_attention`, csrc/attention.cu) as the card runs it, checked
on the CPU: its plan (`k4_plan`: CTAs per cluster and key tile) pinned at
the TinyLlama and Llama-2-7B shapes, its shared-memory size mirrored from
the source, one launch per call with the plan's arguments, and its split
softmax re-enacted in plain torch (the live prefix cut across the CTAs of a
cluster and their warps, each warp's and CTA's (m, l) merged before any p
is formed, pass 2 against the global values, the partial outputs added in
the kernel's order) and held against `decode_attention_plain` and the JAX
package's Pallas `decode_attention` in interpret mode."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gguf_tpu.ops.attention import decode_attention as jax_attend
from gguf_tpu_torch.ops import build
from gguf_tpu_torch.ops.attention import (K4_SMEM, K4_WARPS, NEG_INF,
                                          _attend_cuda, decode_attention,
                                          decode_attention_plain, k4_plan,
                                          k4_smem_bytes)

ATT = importlib.import_module("gguf_tpu_torch.ops.attention")
B, H, KVH, HD, S, SPAN = 4, 4, 2, 64, 256, 128
# f32 softmax and bf16 operands (under "fast") summed in another order
TOL = 1e-3


def _k4_reenacted(q, k, ks, v, vs, pos, *, t, precision, span, window=0,
                  softcap=0.0, clusters, tile):
    """K4's arithmetic in torch, in the kernel's order: per (slot, KV head)
    the live keys (up to pos + t - 1, or the whole span when a row's limit
    reaches it) cut into `clusters` ranges, each walked in tiles of `tile`
    keys; a row's max and sum taken per warp (32-key groups dealt to
    K4_WARPS // rows warps per row), per tile and per CTA, merged in rank
    order before p = e / l is formed; pv = round(p * v_scale); p . v per
    warp (contiguous key ranges), added in warp, tile and rank order."""
    b, h, _, hd = q.shape
    kvh = k.shape[1]
    rows = h // kvh * t
    dt = torch.bfloat16 if precision == "fast" else torch.float32
    qr = q.reshape(b, kvh, rows, hd).to(dt).float()
    wpr = max(1, K4_WARPS // rows)
    out = torch.zeros(b, kvh, rows, hd)
    for bi in range(b):
        p0 = int(pos[bi])
        live = p0 + t if 0 <= p0 and p0 + t < span else span
        per = -(-live // clusters)
        lim = (p0 + torch.arange(rows) % t)[:, None]
        ctas = [(c * per, max(0, min(live, c * per + per) - c * per))
                for c in range(clusters)]
        tiles = [[(c0 + j0, min(tile, nk - j0)) for j0 in range(0, nk, tile)]
                 for c0, nk in ctas]
        for hi in range(kvh):
            def scores(lo, n):
                cols = torch.arange(lo, lo + n)
                s = qr[bi, hi] @ k[bi, hi, lo:lo + n].float().T
                s = s * (ks[bi, hi, lo:lo + n] * (1.0 / hd ** 0.5))
                if softcap:
                    s = softcap * torch.tanh(s * (1.0 / softcap))
                ok = cols <= lim
                if window:
                    ok = ok & (cols > lim - window)
                return torch.where(ok, s, torch.full_like(s, NEG_INF))

            def warps(n):   # a row's keys by the warp that reduces them
                j = torch.arange(n)
                return [j[(j // 32) % wpr == sub] for sub in range(wpr)]

            m = torch.full((rows,), -torch.inf)
            for cta in tiles:
                m_c = torch.full((rows,), -torch.inf)
                for lo, n in cta:
                    s = scores(lo, n)
                    for js in warps(n):
                        if len(js):
                            m_c = torch.maximum(m_c, s[:, js].amax(-1))
                m = torch.maximum(m, m_c)
            l = torch.zeros(rows)
            for cta in tiles:
                l_c = torch.zeros(rows)
                for lo, n in cta:
                    e = torch.exp(scores(lo, n) - m[:, None])
                    for js in warps(n):
                        l_c = l_c + e[:, js].sum(-1)
                l = l + l_c
            for cta in tiles:
                o_c = torch.zeros(rows, hd)
                for lo, n in cta:
                    e = torch.exp(scores(lo, n) - m[:, None])
                    pv = ((e / l[:, None]) * vs[bi, hi, lo:lo + n]).to(dt).float()
                    kw = -(-n // K4_WARPS)
                    acc = torch.zeros(rows, hd)
                    for w in range(K4_WARPS):
                        sl = slice(w * kw, min(n, w * kw + kw))
                        acc = acc + pv[:, sl] @ v[bi, hi, lo + sl.start:
                                                  lo + sl.stop].float()
                    o_c = o_c + acc
                out[bi, hi] = out[bi, hi] + o_c
    return out.reshape(b, h, t, hd)


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (B, KVH, S, HD)).astype(np.int8)
    v = rng.integers(-127, 128, (B, KVH, S, HD)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, KVH, S)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, KVH, S)).astype(np.float32)
    q = (rng.standard_normal((B, H, t, HD)) * 2).astype(np.float32)
    # the first row, the last live one, a random one, an inactive slot
    pos = np.array([0, SPAN - t, rng.integers(1, SPAN - t), S], np.int32)
    return q, k, ks, v, vs, pos


def _close(got, ref, what):
    ref = np.asarray(ref)
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err <= TOL * np.max(np.abs(ref)), (what, err, np.max(np.abs(ref)))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 2.0)])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("precision", ["fast", "high"])
def test_split_softmax_matches_plain_and_jax(precision, t, window, softcap):
    """The re-enacted kernel at its plan and at other cluster sizes and
    tiles (uneven ranges, empty CTAs, a range walked in several tiles)
    against the plain version at every slot and the JAX kernel (with a
    window the inactive slot's row has no key at all: the reference's t = 1
    form leaves it undefined, so that row is held to the plain version
    only)."""
    q, k, ks, v, vs, pos = _inputs(t, seed=7 * t + int(window))
    kw = dict(t=t, precision=precision, span=SPAN, window=window,
              softcap=softcap)
    tq, tk, tks, tv, tvs, tpos = (torch.from_numpy(a) for a in
                                  (q, k, ks, v, vs, pos))
    plain = decode_attention_plain(tq, tk, tks, tv, tvs, tpos, **kw)
    ref = np.asarray(jax_attend(*(jnp.asarray(a) for a in
                                  (q, k, ks, v, vs, pos)), **kw))
    keep = slice(None, -1) if window else slice(None)
    _close(plain[keep], ref[keep], "plain vs jax")
    plan = k4_plan(B, KVH, H // KVH, t, SPAN, HD, 132)
    for clusters, tile in (plan, (1, SPAN), (2, 32), (3, 40), (4, 16)):
        got = _k4_reenacted(tq, tk, tks, tv, tvs, tpos, clusters=clusters,
                            tile=tile, **kw)
        _close(got, plain, f"C={clusters} tile={tile} vs plain")
        _close(got[keep], ref[keep], f"C={clusters} tile={tile} vs jax")


def test_live_prefix_skip_is_exact():
    """Keys past pos + t - 1 are masked for every row: exp(NEG_INF - m) is
    exactly 0 in f32 for any m a live score can take, so they add exact
    zeros to l and to p . v, and attending over the live prefix alone
    gives the whole span's output up to the order of the f32 sums."""
    for m in (-1e4, -1.0, 0.0, 3.5, 1e4):
        assert torch.exp(torch.tensor(NEG_INF) - m).item() == 0.0
    t = 1
    q, k, ks, v, vs, pos = (torch.from_numpy(a) for a in _inputs(t, seed=5))
    for bi in range(3):     # the live slots
        p0 = int(pos[bi])
        one = [a[bi:bi + 1] for a in (q, k, ks, v, vs)]
        full = decode_attention_plain(*one, pos[bi:bi + 1], t=t, span=SPAN,
                                      precision="high")
        cut = decode_attention_plain(*one, pos[bi:bi + 1], t=t,
                                     span=p0 + t, precision="high")
        torch.testing.assert_close(cut, full, rtol=0, atol=1e-6)


_SHAPES = {"tinyllama": (4, 8, 64), "7b": (32, 1, 128)}
# (KV heads, G, hd), t -> k4_plan at spans 128, 512, 2048 (16 slots, 132 SMs)
_PLANS = {("tinyllama", 1): [(2, 64), (2, 256), (2, 1024)],
          ("tinyllama", 8): [(2, 64), (4, 128), (4, 512)],
          ("7b", 1): [(1, 128), (1, 512), (1, 2048)],
          ("7b", 8): [(1, 128), (1, 512), (1, 2048)]}


@pytest.mark.parametrize("span", [128, 512, 2048])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("model", sorted(_SHAPES))
def test_plan(model, t, span):
    """TinyLlama's 64 (slot, KV head) blocks take clusters of 2 CTAs at t
    = 1 and of 4 at t = 8 (64 query rows; 2 at span 128, where a CTA keeps
    64 rows of the span); Llama-2-7B's 512 fill the card alone. On these
    shapes a CTA's scores always fit in shared memory: one tile covers its
    range."""
    kvh, g, hd = _SHAPES[model]
    clusters, tile = k4_plan(16, kvh, g, t, span, hd, 132)
    assert (clusters, tile) == _PLANS[model, t][[128, 512, 2048].index(span)]
    assert tile >= -(-span // clusters)
    assert k4_smem_bytes(g * t, hd, tile) <= K4_SMEM


def test_plan_tiles_a_range_too_large_for_shared_memory():
    """192 query rows of 64 (the wrapper's 48 KiB query tile) over 8,192
    rows: the scores of a CTA's range do not fit, so it takes tiles of a
    multiple of 32 keys that do."""
    clusters, tile = k4_plan(1, 1, 192, 1, 8192, 64, 132)
    assert clusters == 4 and tile % 32 == 0 and tile < 8192 // 4
    assert k4_smem_bytes(192, 64, tile) <= K4_SMEM
    assert k4_smem_bytes(192, 64, tile + 32) > K4_SMEM


def test_smem_bytes_mirror_the_kernel():
    """`k4_smem_bytes` is csrc/attention.cu's AttnSmem total, evaluated
    from the source's initializer list."""
    with open(os.path.join(build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    body = src[src.index("struct AttnSmem {"):]
    inits = body[body.index(": q(0)") + 1:body.index("{}")]
    for rows, hd, kt in ((1, 128, 512), (8, 64, 128), (64, 64, 512),
                         (8, 128, 2048), (3, 64, 37)):
        env = {"R": rows, "HD": hd, "RB": 1 if rows == 1 else 8, "kt": kt,
               "WARPS": K4_WARPS, "up4": lambda n: (n + 3) & ~3}
        for name, expr in re.findall(r"(\w+)\(([^()]*(?:\([^()]*\)[^()]*)*)\)",
                                     inits):
            env[name] = eval(expr.replace("/", "//"), env)
        assert 4 * env["total"] == k4_smem_bytes(rows, hd, kt)


class _FakeLib:
    """A C library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("model,t,insert", [
    ("tinyllama", 1, False), ("tinyllama", 1, True), ("tinyllama", 8, False),
    ("7b", 1, False), ("7b", 1, True), ("7b", 8, False)])
def test_one_launch_with_the_plan(monkeypatch, model, t, insert):
    """Each K4 call is one launch of decode_attention_launch carrying the
    plan's cluster size and tile (and the insert flag, fused at t = 1)."""
    lib = _FakeLib()
    monkeypatch.setattr(ATT, "_lib", lambda: lib)
    monkeypatch.setattr(ATT, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    kvh, g, hd = _SHAPES[model]
    b, s, span = 2, 1024, 512
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    q = torch.zeros((b, kvh * g, t, hd))
    new = torch.zeros((b, kvh, 1, hd)) if insert else None
    before = decode_attention.launches
    out = _attend_cuda(q, new, new, k, sc, k.clone(), sc.clone(),
                       torch.zeros(b, dtype=torch.int32), t=t,
                       precision="fast", span=span, window=0, softcap=0.0)
    assert out.shape == q.shape and decode_attention.launches == before + 1
    assert [name for name, _ in lib.calls] == ["decode_attention_launch"]
    args = lib.calls[0][1]
    assert args[9:16] == (b, kvh, g, t, s, span, hd)
    assert args[18:] == (0, 1 | (2 if insert else 0),
                         *k4_plan(b, kvh, g, t, span, hd, 132), None)


def test_guard_takes_the_launchers_query_tile(monkeypatch):
    """16 query heads per KV head at t = 8 and hd 128 (128 query rows, a
    64 KiB query tile) fit the shared memory K4's launcher opts into: the
    guard takes them and the launch carries `k4_plan`'s 96-key tile; 64
    query heads per KV head (512 rows) do not fit even a 32-key tile and
    are refused before any launch."""
    lib = _FakeLib()
    monkeypatch.setattr(ATT, "_lib", lambda: lib)
    monkeypatch.setattr(ATT, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    b, kvh, hd, s, span, t = 16, 8, 128, 1024, 512, 8
    assert k4_smem_bytes(16 * t, hd, 32) == 186640 <= K4_SMEM
    assert k4_plan(b, kvh, 16, t, span, hd, 132)[1] == 96
    k = torch.zeros((b, kvh, s, hd), dtype=torch.int8)
    sc = torch.zeros((b, kvh, s))
    pos = torch.zeros(b, dtype=torch.int32)
    kw = dict(t=t, precision="fast", span=span, window=0, softcap=0.0)
    out = _attend_cuda(torch.zeros((b, 16 * kvh, t, hd)), None, None, k, sc,
                       k.clone(), sc.clone(), pos, **kw)
    assert out.shape == (b, 16 * kvh, t, hd)
    assert lib.calls[0][1][-3:] == (*k4_plan(b, kvh, 16, t, span, hd, 132),
                                    None)
    assert k4_smem_bytes(64 * t, hd, 32) > K4_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        _attend_cuda(torch.zeros((b, 64 * kvh, t, hd)), None, None, k, sc,
                     k.clone(), sc.clone(), pos, **kw)
    assert len(lib.calls) == 1
