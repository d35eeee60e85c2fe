"""INT8 KV-cache insert (K3), GQA decode attention (K4) and flash-decoding
over long spans (K9), with their plain PyTorch versions.

Counterpart of `gguf_tpu/ops/attention.py`: `kv_cache_insert` (Pallas
`_insert_kernel`), `decode_attention` (`_attn_kernel`),
`decode_attention_tiled` (`_attn_tiled_kernel`) and
`decode_attention_update` (the split pair, or `_fused_attn_kernel` at
t = 1). The CUDA sources are `gguf_tpu_torch/csrc/attention.cu` (K3, K4)
and `csrc/attention_tiled.cu` (K9), sharing the row quantizer of
`csrc/kv_quant.cuh`.

Routing follows the reference: at t = 1, once KVH * span * hd exceeds
`PALLAS_ATTN_MAX_ELEMS` and span is a multiple of 256, `decode_attention`
(and so `decode_attention_update`) delegates to `decode_attention_tiled`.

Layouts match the reference: q (B, H, t, hd); new K/V rows (B, KVH, t, hd)
float32; the cache k/v (B, KVH, S, hd) int8 with per-row float32 scales
(B, KVH, S); pos (B,) int32, the position of each sequence's first new
token. The cache is updated IN PLACE (the JAX package aliases the same
buffers); the functions return the cache tensors they were given. K3 and
K4 (and their plain versions) take an optional `rows` (B,) int32 on the
cache's device: sequence b then reads and writes cache batch row rows[b]
of a cache of any batch, the row read on the device (a prefill chunk's
CUDA graph addresses its slot so); without it, row b.

Quantization is per (token, head) row and bit-identical to the reference
as XLA compiles it (`gguf_tpu/models/llama.py:_quantize_kv` and the Pallas
inserts under jit): scale = absmax * f32(1/127) — XLA turns the division
by the constant 127 into that product, and for a bf16 row it keeps absmax
and the scale in f32 — then codes = clip(rint(x / scale), ±127) with an
IEEE division and round-half-to-even. A position outside [0, S) writes
nothing: inactive engine slots step at pos = max_seq.

K4 is one launch per call: a thread-block cluster of `k4_plan`'s size per
(batch, KV head) splits the live prefix of the span (the rows up to pos +
t - 1) across its CTAs and their warps, merges the rows' max and sum over
the cluster before any p is formed (the reference's two-pass softmax), and
adds the partial outputs in a fixed order (csrc/attention.cu says how).
K9 is one launch per call too: a cluster of `k9_plan`'s size per (batch,
KV head) splits the live rows, streams them through a ring of bulk copies
and merges the reference's per-tile running max over the cluster
(csrc/attention_tiled.cu says how). On the card the t = 1 insert is fused
into whichever of K4 and K9 the step takes: K3 runs on its own only for t
> 1.

`kv_cache_insert.launches` counts K3 launches,
`decode_attention.launches` counts K4 launches, whether K4 runs read-only
or with its fused t = 1 insert, and `decode_attention_tiled.launches`
counts K9 launches likewise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .mmq_q4_k import sm_count

NEG_INF = float(torch.finfo(torch.float32).min)
RECIP_127 = float(torch.tensor(1 / 127, dtype=torch.float32))
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {
    "kv_cache_insert_launch": [_VP] * 8 + [_I] * 5 + [_VP],
    "decode_attention_launch": [_VP] * 10 + [_I] * 7 + [_F, _F] + [_I] * 4
    + [_VP],
}
_SIG_TILED = {
    "decode_attention_tiled_launch": [_VP] * 9 + [_I] * 6 + [_F, _F]
    + [_I] * 5 + [_VP],
}
HEAD_DIMS = (64, 128)
# single-tile envelope (cache elements per batch element) past which the
# reference sends t = 1 to its tiled kernel (`gguf_tpu/ops/attention.py`
# PALLAS_ATTN_MAX_ELEMS; `models/llama.py:attention` keys off it too)
PALLAS_ATTN_MAX_ELEMS = 2 ** 21
TILE = 256                  # cache rows per tile of the tiled form
K4_WARPS = 8                # warps per CTA of K4 (csrc/attention.cu)
K4_MAX_CLUSTER = 4          # CTAs per (batch, KV head)
K4_SMEM = 232448            # shared memory a block can use on an H100 (K4, K9)
K9_SHARE = 233472 // 2 - 1024  # what lets two blocks share an H100 SM
K9_STAGES, K9_CHUNK = 3, 64  # K9's ring: stages of cache rows (attention_tiled.cu)
K9_GB = 8                   # K9's query rows per p . v block where G > 1
K9_MAX_CLUSTER = 8
K9_SPLIT_SPAN = 1024        # spans above it take at least 2 K9 CTAs per cluster


def quantize_kv(x: torch.Tensor):
    """(..., hd) f32 or bf16 -> int8 codes + per-row float32 scales."""
    scale = x.abs().amax(dim=-1).float() * RECIP_127
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x.float() / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _lib():
    return build.load("attention", _SIG)


def _lib_tiled():
    return build.load("attention_tiled", _SIG_TILED)


def _on_card(x: torch.Tensor) -> bool:
    """Does this call launch kernels (a CUDA tensor) rather than the plain
    versions (a CPU one)?"""
    return x.device.type == "cuda"


def _check_cache(k, k_scale, v, v_scale, pos, rows=None):
    """(B, KVH, S, hd): B the sequences (pos's), the cache's batch unless
    `rows` picks their cache rows."""
    bc, kvh, s, hd = k.shape
    b = bc if rows is None else rows.shape[0]
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError("the KV cache is int8")
    if v.shape != k.shape or k_scale.shape != (bc, kvh, s) \
            or v_scale.shape != (bc, kvh, s):
        raise ValueError("cache and scale shapes disagree")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("cache scales are float32")
    if pos.shape != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if rows is not None and (rows.ndim != 1 or rows.dtype != torch.int32):
        raise ValueError("rows must be (B,) int32")
    for t in (k, k_scale, v, v_scale):
        if not t.is_contiguous():
            raise ValueError("the KV cache must be contiguous")
    _check_device(k, k_scale, v, v_scale, pos,
                  *(() if rows is None else (rows,)))
    return b, kvh, s, hd


def _rows_ptr(rows):
    """The row index's device pointer, or NULL (sequence b at row b)."""
    return None if rows is None else build.ptr(rows)


def cache_rows(c, rows, span: int):
    """The first `span` positions of each sequence's cache row of the
    cache tensor `c` (B, KVH, S, ...): a view without `rows`, else a
    gather of rows[b] on the device."""
    c = c[:, :, :span]
    return c if rows is None else c.index_select(0, rows)


def _check_device(ref, *tensors):
    if any(t.device != ref.device for t in tensors):
        raise ValueError(f"all operands must be on {ref.device}, got "
                         f"{[str(t.device) for t in tensors]}")


def _check_new(new, b, kvh, t, hd):
    if new.shape != (b, kvh, t, hd):
        raise ValueError(f"new rows {tuple(new.shape)} != {(b, kvh, t, hd)}")


# ------------------------------------------------------------- K3: insert ---


def kv_cache_insert_plain(k_new, v_new, k, k_scale, v, v_scale, pos,
                          rows=None):
    """Plain version of K3: quantize and write rows pos..pos+t-1 per
    sequence (into cache row rows[b] where given), skipping rows outside
    [0, S)."""
    b, kvh, s, hd = _check_cache(k, k_scale, v, v_scale, pos, rows)
    t = k_new.shape[2]
    qk, sk = quantize_kv(k_new.float())
    qv, sv = quantize_kv(v_new.float())
    at = pos.to(torch.long)[:, None] + torch.arange(t, device=pos.device)
    cache_rows = range(b) if rows is None else rows.tolist()
    for bi, (bc, r) in enumerate(zip(cache_rows, at.tolist())):
        for tj, row in enumerate(r):
            if 0 <= row < s:
                k[bc, :, row] = qk[bi, :, tj]
                k_scale[bc, :, row] = sk[bi, :, tj]
                v[bc, :, row] = qv[bi, :, tj]
                v_scale[bc, :, row] = sv[bi, :, tj]
    return k, k_scale, v, v_scale


def kv_cache_insert(k_new, v_new, k, k_scale, v, v_scale, pos, rows=None):
    """Quantize t new K/V rows per sequence (scale = absmax * f32(1/127),
    codes by exact division and round half to even) and write them in
    place at pos..pos+t-1 of cache row rows[b] (row b without `rows`).
    Returns the cache tensors."""
    b, kvh, s, hd = _check_cache(k, k_scale, v, v_scale, pos, rows)
    t = k_new.shape[2]
    _check_new(k_new, b, kvh, t, hd)
    _check_new(v_new, b, kvh, t, hd)
    _check_device(k, k_new, v_new)
    if k.device.type == "cpu":
        return kv_cache_insert_plain(k_new, v_new, k, k_scale, v, v_scale, pos,
                                     rows)
    if k.device.type != "cuda" or hd not in HEAD_DIMS:
        raise ValueError(f"kv_cache_insert: cuda with hd in {HEAD_DIMS}, "
                         f"got {k.device} hd={hd}")
    return _insert_cuda(k_new, v_new, k, k_scale, v, v_scale, pos, rows)


def _insert_cuda(k_new, v_new, k, k_scale, v, v_scale, pos, rows=None):
    """Launch K3 on operands `kv_cache_insert` has checked."""
    b, kvh, s, hd = _check_cache(k, k_scale, v, v_scale, pos, rows)
    t = k_new.shape[2]
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    p = pos.to(torch.int32).contiguous()
    err = _lib().kv_cache_insert_launch(
        build.ptr(kn), build.ptr(vn), build.ptr(k), build.ptr(k_scale),
        build.ptr(v), build.ptr(v_scale), build.ptr(p), _rows_ptr(rows), b,
        kvh, t, s, hd, build.stream_ptr())
    build.check(err, "kv_cache_insert")
    kv_cache_insert.launches += 1
    return k, k_scale, v, v_scale


kv_cache_insert.launches = 0


# ---------------------------------------------------------- K4: attention ---


def decode_attention_plain(q, k, k_scale, v, v_scale, pos, *, t: int,
                           precision: str = "fast", span: int | None = None,
                           window: int = 0, softcap: float = 0.0, rows=None):
    """Plain version of K4 (read-only): the reference kernel's math —
    scores (q·k)·(k_scale/√hd), optional softcap, causal (and window)
    mask, f32 softmax, then (p·v_scale) rounded to the operand type
    times v. Returns (B, H, t, hd) float32."""
    b, h, _, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    span = s if span is None else min(span, s)
    k, k_scale, v, v_scale = (cache_rows(c, rows, span)
                              for c in (k, k_scale, v, v_scale))
    dt = torch.bfloat16 if precision == "fast" else torch.float32
    qr = q.reshape(b, kvh, g * t, hd).to(dt).float()
    scores = qr @ k[:, :, :span].float().transpose(-1, -2)
    scores = scores * (k_scale[:, :, None, :span] * (1.0 / hd ** 0.5))
    if softcap:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    tok = torch.arange(g * t, device=q.device) % t
    col = torch.arange(span, device=q.device)
    lim = pos.to(torch.long)[:, None, None, None] + tok[None, None, :, None]
    live = col <= lim
    if window:
        live = live & (col > lim - window)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    pv = (p * v_scale[:, :, None, :span]).to(dt).float()
    out = pv @ v[:, :, :span].float()
    return out.reshape(b, h, t, hd)


def k4_smem_bytes(r: int, hd: int, kt: int) -> int:
    """K4's dynamic shared memory for r query rows and a tile of kt keys
    (csrc/attention.cu: AttnSmem)."""
    def up4(n):
        return (n + 3) & ~3
    rb = 1 if r == 1 else 8
    return 4 * (2 * r * hd + r * up4(kt) + K4_WARPS * rb * hd
                + up4(K4_WARPS * r) + 4 * up4(r) + hd // 2 + 4)


@functools.lru_cache(maxsize=1024)
def k4_plan(b: int, kvh: int, g: int, t: int, span: int, hd: int,
            sms: int) -> tuple:
    """(clusters, tile keys) of K4 for B slots over KVH heads of hd, G
    query heads per KV head, t tokens and `span` cache rows, on `sms` SMs.
    The cluster doubles (up to K4_MAX_CLUSTER CTAs) while twice the CTAs
    still fit the SMs once (twice when the block has more than 8 query
    rows: there a CTA's work outweighs the cluster's barriers) and each
    CTA keeps at least 64 rows of the span; the
    tile is the keys a CTA's range can hold (ceil(span / clusters)) unless
    their scores would outgrow shared memory (then the CTA scores its
    range in tiles, a multiple of 32 keys each). The warp split follows
    the live rows of each call, in the kernel. Cached per shape."""
    r = g * t
    fill = sms * (2 if r > 8 else 1)
    c = 1
    while c < K4_MAX_CLUSTER and 2 * b * kvh * c <= fill and span >= 128 * c:
        c *= 2
    room = (K4_SMEM - k4_smem_bytes(r, hd, 0)) // (4 * r) // 32 * 32
    return c, min(-(-span // c), room)


def _attend_cuda(q, k_new, v_new, k, k_scale, v, v_scale, pos, *, t,
                 precision, span, window, softcap, rows=None):
    """Launch K4; with k_new/v_new given (t = 1) the block first inserts
    its own head's new row, then attends over the updated cache."""
    b, kvh, s, hd = _check_cache(k, k_scale, v, v_scale, pos, rows)
    h = q.shape[1]
    _check_device(k, q, *(() if k_new is None else (k_new, v_new)))
    if q.shape != (b, h, t, hd) or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: hd must be in {HEAD_DIMS}, got {hd}")
    if k4_smem_bytes((h // kvh) * t, hd, 32) > K4_SMEM:
        raise ValueError(f"decode_attention: {(h // kvh) * t} query rows of "
                         f"{hd} and a 32-key tile exceed {K4_SMEM} bytes of "
                         "shared memory")
    span = s if span is None else min(span, s)
    qf = q.float().contiguous()
    p = pos.to(torch.int32).contiguous()
    insert = k_new is not None
    if insert:
        kn, vn = k_new.float().contiguous(), v_new.float().contiguous()
    else:
        kn = vn = qf     # unused by the kernel
    out = torch.empty((b, h, t, hd), dtype=torch.float32, device=q.device)
    clusters, tile = k4_plan(b, kvh, h // kvh, t, span, hd,
                             sm_count(q.device.index or 0))
    err = _lib().decode_attention_launch(
        build.ptr(qf), build.ptr(kn), build.ptr(vn), build.ptr(k),
        build.ptr(k_scale), build.ptr(v), build.ptr(v_scale), build.ptr(p),
        _rows_ptr(rows), build.ptr(out), b, kvh, h // kvh, t, s, span, hd,
        1.0 / hd ** 0.5, float(softcap), int(window),
        int(precision == "fast") | (2 if insert else 0), clusters, tile,
        build.stream_ptr())
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


def _takes_tiled(k, t: int, span: int | None) -> bool:
    """The reference's delegation to the tiled kernel: t = 1, past the
    single-tile envelope, span a multiple of the tile."""
    _, kvh, s, hd = k.shape
    span = s if span is None else min(span, s)
    return (t == 1 and kvh * span * hd > PALLAS_ATTN_MAX_ELEMS
            and span % TILE == 0)


def decode_attention(q, k, k_scale, v, v_scale, pos, *, t: int,
                     precision: str = "fast", span: int | None = None,
                     window: int = 0, softcap: float = 0.0, rows=None):
    """GQA attention of t new tokens per sequence over the first `span`
    cache rows (their K/V already inserted). Returns (B, H, t, hd) f32.
    Single tokens past the envelope take `decode_attention_tiled`, which
    takes no `rows`."""
    if _takes_tiled(k, t, span):
        if rows is not None:
            raise ValueError("decode_attention_tiled takes no cache rows")
        return decode_attention_tiled(q, k, k_scale, v, v_scale, pos,
                                      precision=precision, span=span,
                                      window=window, softcap=softcap)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, k_scale, v, v_scale, pos, t=t,
                                      precision=precision, span=span,
                                      window=window, softcap=softcap,
                                      rows=rows)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    return _attend_cuda(q, None, None, k, k_scale, v, v_scale, pos, t=t,
                        precision=precision, span=span, window=window,
                        softcap=softcap, rows=rows)


decode_attention.launches = 0


def decode_attention_update(q, k_new, v_new, k, k_scale, v, v_scale, pos,
                            *, t: int, precision: str = "fast",
                            span: int | None = None, window: int = 0,
                            softcap: float = 0.0, rows=None):
    """Insert t new K/V rows, then attend: (out, k, k_scale, v, v_scale).
    On the card t = 1 is ONE launch with the insert fused in: K4, or K9
    past the single-tile envelope; t > 1 is K3 then K4. On the CPU the
    plain insert, then the plain attention of the same route. `rows`, the
    cache row of each sequence, as K3 and K4 take it."""
    if _on_card(q) and t == 1:
        kvh, hd = k.shape[1], k.shape[3]
        b = k.shape[0] if rows is None else rows.shape[0]
        _check_new(k_new, b, kvh, 1, hd)
        _check_new(v_new, b, kvh, 1, hd)
        kw = dict(precision=precision, span=span, window=window,
                  softcap=softcap)
        if _takes_tiled(k, t, span):
            if rows is not None:
                raise ValueError("decode_attention_tiled takes no cache rows")
            out = _tiled_cuda(q, k_new, v_new, k, k_scale, v, v_scale, pos,
                              **kw)
        else:
            out = _attend_cuda(q, k_new, v_new, k, k_scale, v, v_scale, pos,
                               t=1, rows=rows, **kw)
        return out, k, k_scale, v, v_scale
    kv_cache_insert(k_new, v_new, k, k_scale, v, v_scale, pos, rows=rows)
    out = decode_attention(q, k, k_scale, v, v_scale, pos, t=t,
                           precision=precision, span=span, window=window,
                           softcap=softcap, rows=rows)
    return out, k, k_scale, v, v_scale


# ------------------------------------------------ K9: tiled (long spans) ---


def decode_attention_tiled_plain(q, k, k_scale, v, v_scale, pos, *,
                                 precision: str = "fast",
                                 span: int | None = None, window: int = 0,
                                 softcap: float = 0.0):
    """Plain version of K9, in the reference kernel's order: 256-row tiles
    in turn with an online softmax (running max m, sum l, accumulator),
    p = exp(s - m) against the running max, (p * v_scale) rounded to the
    operand type times v, out = acc / l. A fully masked leading tile adds
    p = 1 everywhere and is wiped by alpha = 0 at the first live one, as
    there. Returns (B, H, 1, hd) float32."""
    b, h, _, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    span = s if span is None else min(span, s)
    dt = torch.bfloat16 if precision == "fast" else torch.float32
    qr = q.reshape(b, kvh, g, hd).to(dt).float()
    lim = pos.to(torch.long)[:, None, None, None]
    m = torch.full((b, kvh, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, hd), device=q.device)
    for t0 in range(0, span, TILE):
        rows = slice(t0, t0 + TILE)
        sc = qr @ k[:, :, rows].float().transpose(-1, -2)
        sc = sc * (k_scale[:, :, None, rows] * (1.0 / hd ** 0.5))
        if softcap:
            sc = softcap * torch.tanh(sc * (1.0 / softcap))
        col = torch.arange(t0, t0 + TILE, device=q.device)
        live = col <= lim
        if window:
            live = live & (col > lim - window)
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = (p * v_scale[:, :, None, rows]).to(dt).float()
        acc = acc * alpha + pv @ v[:, :, rows].float()
        m = m_new
    return (acc / l).reshape(b, h, 1, hd)


def k9_smem_bytes(g: int, rows: int, hd: int, held: int | None = None) -> int:
    """K9's dynamic shared memory for G query rows, slices of at most
    `rows` cache rows and `held` of them (all by default) in shared memory
    at a time (csrc/attention_tiled.cu: TiledSmem)."""
    def up4(n):
        return (n + 3) & ~3
    rb = 1 if g == 1 else K9_GB
    ntl = rows // TILE + 2
    held = rows if held is None else min(held, rows)
    return (K9_STAGES * K9_CHUNK * hd + 8 * K9_STAGES + 8 * (K9_STAGES % 2) + 4 * g * hd
            + 4 * (2 + g) * up4(held) + 3 * 4 * up4(g * ntl)
            + 4 * 3 * K9_MAX_CLUSTER * g + 4 * K4_WARPS * rb * hd
            + 4 * up4(K4_WARPS * rb) + 4 * up4(g * hd + K9_MAX_CLUSTER)
            + 2 * hd + 16)


@functools.lru_cache(maxsize=1024)
def k9_plan(b: int, kvh: int, g: int, span: int, hd: int, sms: int) -> tuple:
    """(clusters, rows held) of K9 for B slots over KVH heads of hd, G
    query heads per KV head and `span` cache rows, on `sms` SMs. The
    cluster is the smallest power of two up to K9_MAX_CLUSTER that has 2
    CTAs or more where span > K9_SPLIT_SPAN, whose B * KVH clusters' CTAs
    cover the SMs, and whose slices' scores fit in shared memory if 8 CTAs
    can make them fit. A CTA costs a few microseconds of its own (the
    first copies' latency, the cluster barriers), so few, long CTAs win
    until the longest slot's tail takes over: on the H100 at Llama-2-7B's
    16 slots (the one shape this was tuned at) 1 CTA timed best at span
    1024 and 2 at 2048 and 4096 (4 lost at both). The rows held are the
    whole slice, ceil(span / clusters), where its scores fit; else the
    kernel walks the slice in sub-slices (and scores each twice) of the
    most rows, a multiple of K9_CHUNK, that let two CTAs share an SM
    (K9_SHARE; 25-35% faster than one CTA holding more at Llama-3's
    geometries on the H100), or failing that of what fits at all: 0 where
    not even K9_CHUNK rows fit. Cached per shape."""
    c = 1
    while c < K9_MAX_CLUSTER and (
            c == 1 and span > K9_SPLIT_SPAN or b * kvh * c < sms
            or k9_smem_bytes(g, -(-span // c), hd) > K4_SMEM):
        c *= 2
    rows = -(-span // c)
    if k9_smem_bytes(g, rows, hd) <= K4_SMEM:
        return c, rows
    fixed = k9_smem_bytes(g, rows, hd, 0)
    for room in (K9_SHARE, K4_SMEM):
        held = (room - fixed) // (4 * (2 + g)) // K9_CHUNK * K9_CHUNK
        if held >= K9_CHUNK:
            return c, held
    return c, 0


def _check_tiled(q, k, k_scale, v, v_scale, pos, span):
    """The tiled form's operands: (B, KVH, S, hd, G, span)."""
    b, kvh, s, hd = _check_cache(k, k_scale, v, v_scale, pos)
    h = q.shape[1]
    _check_device(k, q)
    if q.shape != (b, h, 1, hd) or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k.shape)}")
    span = s if span is None else min(span, s)
    if span % TILE:
        raise ValueError(f"span {span} must be a multiple of {TILE}")
    return b, kvh, s, hd, h // kvh, span


def _tiled_cuda(q, k_new, v_new, k, k_scale, v, v_scale, pos, *,
                precision, span, window, softcap):
    """Launch K9; with k_new/v_new given the cluster first quantizes its
    head's new row and writes it to the cache, reading its own copy for
    row pos."""
    b, kvh, s, hd, g, span = _check_tiled(q, k, k_scale, v, v_scale, pos,
                                          span)
    if k_new is not None:
        _check_device(k, k_new, v_new)
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention_tiled: hd must be in {HEAD_DIMS}, "
                         f"got {hd}")
    clusters, held = k9_plan(b, kvh, g, span, hd,
                             sm_count(q.device.index or 0))
    if not held:
        raise ValueError(f"decode_attention_tiled: {g} query rows of {hd} "
                         f"and {K9_CHUNK} cache rows exceed {K4_SMEM} bytes "
                         "of shared memory")
    qf = q.float().contiguous()
    p = pos.to(torch.int32).contiguous()
    insert = k_new is not None
    if insert:
        kn, vn = k_new.float().contiguous(), v_new.float().contiguous()
    else:
        kn = vn = qf     # unused by the kernel
    out = torch.empty((b, kvh * g, 1, hd), dtype=torch.float32,
                      device=q.device)
    err = _lib_tiled().decode_attention_tiled_launch(
        build.ptr(qf), build.ptr(kn), build.ptr(vn), build.ptr(k),
        build.ptr(k_scale), build.ptr(v), build.ptr(v_scale), build.ptr(p),
        build.ptr(out), b, kvh, g, s, span, hd, 1.0 / hd ** 0.5,
        float(softcap), int(window),
        int(precision == "fast") | (2 if insert else 0), clusters,
        -(-span // clusters), held, build.stream_ptr())
    build.check(err, "decode_attention_tiled")
    decode_attention_tiled.launches += 1
    return out


def decode_attention_tiled(q, k, k_scale, v, v_scale, pos, *,
                           precision: str = "fast", span: int | None = None,
                           window: int = 0, softcap: float = 0.0):
    """Single-token GQA attention over the first `span` cache rows in
    256-row tiles (span a multiple of 256): the contract of
    `decode_attention` at t = 1, for spans past the single-tile envelope.
    q (B, H, 1, hd) with rope applied; returns (B, H, 1, hd) float32. On
    the card one call is one K9 launch."""
    span = _check_tiled(q, k, k_scale, v, v_scale, pos, span)[-1]
    kw = dict(precision=precision, span=span, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return decode_attention_tiled_plain(q, k, k_scale, v, v_scale, pos,
                                            **kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_tiled runs on cpu or cuda, not "
                         f"{q.device}")
    return _tiled_cuda(q, None, None, k, k_scale, v, v_scale, pos, **kw)


decode_attention_tiled.launches = 0
