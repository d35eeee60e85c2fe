"""Plain float32 reference of a llama-architecture GGUF model with a dense
FFN, for the configurations whose `reference` is "llama"; its
dequantizers serve the references of other architectures too.

Written from the GGUF and llama.cpp definitions, independent of the
port: it imports nothing of `gguf_tpu_torch` and takes only the tensors
the harness made from the seed. Per layer: RMSNorm, q/k/v
projections, rotary embedding in llama.cpp's NORM order (pairs 2j, 2j+1:
the order llama.cpp's converter permutes llama and mistral q/k weights
into), K and V rounded through the served INT8 cache (one absmax/127
scale per token and KV head), causal grouped-query attention with a
softmax in float32, the output projection, and the SwiGLU MLP; then the
final norm and the head. Every product runs in float32 with TF32 off.

It runs after the window, layer by layer over the sampled requests, so
that its memory stays small: one layer's matrices dequantized at a time.
"""

from __future__ import annotations

import math

import torch

from ..archs.llama import PROJECTIONS
from ..model import F32, Model


def _f16(b: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8 little-endian fp16 bytes -> (...) float32."""
    return b.contiguous().view(torch.float16)[..., 0].float()


def _scale_min_k4(sc: torch.Tensor):
    """llama.cpp `get_scale_min_k4` for j = 0..7 over the 12 packed bytes:
    (scales, mins), each (..., 8)."""
    q = sc.int()
    lo_s = q[..., 0:4] & 63
    lo_m = q[..., 4:8] & 63
    hi_s = (q[..., 8:12] & 15) | ((q[..., 0:4] >> 6) << 4)
    hi_m = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return (torch.cat([lo_s, hi_s], -1).float(),
            torch.cat([lo_m, hi_m], -1).float())


def dequant_q4_k(raw: torch.Tensor, k: int) -> torch.Tensor:
    """llama.cpp `dequantize_row_q4_K`: 144-byte blocks of d, dmin, 12
    scale bytes and 128 code bytes; 64-element groups j take the low
    nibbles (sub-block 2j) then the high nibbles (2j + 1) of 32 bytes."""
    blk = raw.reshape(raw.shape[0], k // 256, 144)
    d, dmin = _f16(blk[..., 0:2]), _f16(blk[..., 2:4])
    sc, mn = _scale_min_k4(blk[..., 4:16])
    qs = blk[..., 16:144].int().reshape(*blk.shape[:2], 4, 32)
    q = torch.stack([qs & 15, qs >> 4], dim=3).reshape(*blk.shape[:2], 8, 32)
    y = (d[..., None] * sc)[..., None] * q - (dmin[..., None] * mn)[..., None]
    return y.reshape(raw.shape[0], k)


def dequant_q6_k(raw: torch.Tensor, k: int) -> torch.Tensor:
    """llama.cpp `dequantize_row_q6_K`: 210-byte blocks of 128 ql, 64 qh,
    16 int8 scales and d; each 128-element half n takes ql[64n:64n+64],
    qh[32n:32n+32] and scales[8n:8n+8]."""
    blk = raw.reshape(raw.shape[0], k // 256, 210)
    ql = blk[..., 0:128].int().reshape(*blk.shape[:2], 2, 64)
    qh = blk[..., 128:192].int().reshape(*blk.shape[:2], 2, 32)
    sc = blk[..., 192:208].contiguous().view(torch.int8).float().reshape(
        *blk.shape[:2], 2, 8)
    d = _f16(blk[..., 208:210])
    a, b = ql[..., 0:32], ql[..., 32:64]
    q = torch.stack([(a & 15) | ((qh & 3) << 4),
                     (b & 15) | (((qh >> 2) & 3) << 4),
                     (a >> 4) | (((qh >> 4) & 3) << 4),
                     (b >> 4) | (((qh >> 6) & 3) << 4)], dim=3) - 32
    # element l of quarter r in half n uses scale index (l // 16) + 2 r
    s = sc.reshape(*blk.shape[:2], 2, 4, 2)                 # (n, r, l // 16)
    y = q.float().reshape(*blk.shape[:2], 2, 4, 2, 16) * s[..., None]
    return (d[..., None, None, None, None] * y).reshape(raw.shape[0], k)


def dequant_q8_0(raw: torch.Tensor, k: int) -> torch.Tensor:
    """34-byte blocks of an fp16 d and 32 int8 codes: x = d * q."""
    blk = raw.reshape(raw.shape[0], k // 32, 34)
    q = blk[..., 2:34].contiguous().view(torch.int8).float()
    return (_f16(blk[..., 0:2])[..., None] * q).reshape(raw.shape[0], k)


def dequant_q5_k(raw: torch.Tensor, k: int) -> torch.Tensor:
    """llama.cpp `dequantize_row_q5_K`: 176-byte blocks of d, dmin, 12
    scale bytes, 32 qh bytes and 128 qs bytes; 64-element groups j take
    the low nibbles (sub-block 2j) then the high nibbles (2j + 1) of 32 qs
    bytes, each plus 16 where bit 2j (2j + 1) of the element's qh byte is
    set."""
    blk = raw.reshape(raw.shape[0], k // 256, 176)
    d, dmin = _f16(blk[..., 0:2]), _f16(blk[..., 2:4])
    sc, mn = _scale_min_k4(blk[..., 4:16])
    qh = blk[..., 16:48].int()
    qs = blk[..., 48:176].int().reshape(*blk.shape[:2], 4, 32)
    q = torch.stack([qs & 15, qs >> 4], dim=3).reshape(*blk.shape[:2], 8, 32)
    bit = torch.arange(8, device=raw.device)[:, None]
    q = q + 16 * ((qh[..., None, :] >> bit) & 1)
    y = (d[..., None] * sc)[..., None] * q - (dmin[..., None] * mn)[..., None]
    return y.reshape(raw.shape[0], k)


def dequant_q2_k(raw: torch.Tensor, k: int) -> torch.Tensor:
    """llama.cpp `dequantize_row_q2_K`: 84-byte blocks of 16 scale bytes
    (low nibble the scale, high nibble the min), 64 qs bytes, d and dmin;
    each 128-element half n takes qs[32n:32n+32], and its 16-element
    sub-blocks 8n + 2j and 8n + 2j + 1 the 2-bit codes at shift 2j of
    bytes 0-15 and 16-31."""
    blk = raw.reshape(raw.shape[0], k // 256, 84)
    sc = blk[..., 0:16].int()
    qs = blk[..., 16:80].int().reshape(*blk.shape[:2], 2, 1, 32)
    d, dmin = _f16(blk[..., 80:82]), _f16(blk[..., 82:84])
    shift = 2 * torch.arange(4, device=raw.device)[:, None]
    q = ((qs >> shift) & 3).reshape(*blk.shape[:2], 16, 16)
    y = ((d[..., None] * (sc & 15).float())[..., None] * q
         - (dmin[..., None] * (sc >> 4).float())[..., None])
    return y.reshape(raw.shape[0], k)


def dequant_q3_k(raw: torch.Tensor, k: int) -> torch.Tensor:
    """llama.cpp `dequantize_row_q3_K`: 110-byte blocks of 32 hmask bytes,
    64 qs bytes, 12 bytes packing 16 6-bit scales and d; each 128-element
    half n takes qs[32n:32n+32], and its sub-blocks 8n + 2j and
    8n + 2j + 1 the 2-bit codes at shift 2j of bytes 0-15 and 16-31, less
    4 where bit 4n + j of the element's hmask byte is clear, times
    d * (scale - 32)."""
    blk = raw.reshape(raw.shape[0], k // 256, 110)
    hm = blk[..., 0:32].int().reshape(*blk.shape[:2], 1, 1, 32)
    qs = blk[..., 32:96].int().reshape(*blk.shape[:2], 2, 1, 32)
    a, b, c = (blk[..., 96 + 4 * i:100 + 4 * i].int() for i in range(3))
    sc = torch.cat([(a & 15) | ((c & 3) << 4), (b & 15) | (((c >> 2) & 3) << 4),
                    (a >> 4) | (((c >> 4) & 3) << 4),
                    (b >> 4) | (((c >> 6) & 3) << 4)], -1) - 32
    d = _f16(blk[..., 108:110])
    j = torch.arange(4, device=raw.device)[:, None]
    bit = torch.arange(8, device=raw.device).reshape(2, 4, 1)
    q = ((qs >> (2 * j)) & 3) - 4 * (1 - ((hm >> bit) & 1))
    y = ((d[..., None] * sc.float())[..., None]
         * q.reshape(*blk.shape[:2], 16, 16).float())
    return y.reshape(raw.shape[0], k)


DEQUANT = {"q2_k": dequant_q2_k, "q3_k": dequant_q3_k, "q4_k": dequant_q4_k,
           "q5_k": dequant_q5_k, "q6_k": dequant_q6_k, "q8_0": dequant_q8_0}


def dequant(entry, rows=None) -> torch.Tensor:
    """(format, shape, the harness's view) -> float32 of `shape` (an F32
    tensor as it is), or only the leading-axis entries `rows`: a block
    tensor's view is uint8 (*shape[:-1], bytes per row), dequantized row by
    row."""
    fmt, shape, raw = entry
    if rows is not None:
        raw = raw[rows]
    if fmt == F32:
        return raw.float()
    flat = raw.reshape(-1, raw.shape[-1])
    return DEQUANT[fmt](flat, shape[-1]).reshape(*raw.shape[:-1], shape[-1])


def rms_norm(x: torch.Tensor, eps: float, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_norm(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """llama.cpp ROPE_TYPE_NORM on (L, heads, hd): pairs (2j, 2j + 1)
    rotate by pos * theta^(-2j / hd)."""
    hd = x.shape[-1]
    freq = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                   device=x.device) / hd)
    ang = (pos.double()[:, None] * freq[None, :]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).reshape(x.shape)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """Round each row (last axis) through the served cache: codes
    round(x / s) in -127..127 with s = absmax / 127."""
    s = x.abs().amax(-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def attention(m: Model, q, k, v) -> torch.Tensor:
    """Causal GQA over one sequence: q (L, H, hd), k/v (L, KVH, hd)."""
    g = m.heads // m.kv_heads
    n = q.shape[0]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, L, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    s = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(m.head_dim)
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return (p @ v).transpose(0, 1).reshape(n, -1)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Round each row to float8 e4m3 with one absmax / 448 scale: the
    control's activations."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def served_gaps(m: Model, weights: dict, requests: list, device) -> list:
    """For each (prompt ids, served ids) request: the gap by which each
    served token's logit lies below the reference's best at its position
    (0 where it is the reference's argmax), as a float64 numpy array."""
    with _no_tf32():
        rows = _served_logits(m, weights, requests, torch.device(device))
        out = []
        for (_, served), logits in zip(requests, rows):
            chosen = torch.tensor(list(served), dtype=torch.long,
                                  device=logits.device)
            out.append(_gap(logits, chosen))
        return out


def control_gaps(m: Model, weights: dict, requests: list, device) -> list:
    """The control: the reference in the program's place with every
    product's activations rounded to float8 e4m3, over the same prompts
    and served tokens; at each position the gap below the f32
    reference's best of the token the control puts first."""
    with _no_tf32():
        dev = torch.device(device)
        exact = _served_logits(m, weights, requests, dev)
        low = _served_logits(m, weights, requests, dev, act=fp8_rows)
        return [_gap(e, lo.argmax(-1)) for e, lo in zip(exact, low)]


def _gap(logits: torch.Tensor, chosen: torch.Tensor):
    best = logits.max(-1).values
    return (best - logits.gather(1, chosen[:, None])[:, 0]).double().cpu().numpy()


class _no_tf32:
    def __enter__(self):
        self.allow = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.allow


def _served_logits(m: Model, weights: dict, requests: list, device,
                   act=lambda x: x) -> list:
    """Each request's logits (f32) at the positions that predict its
    served tokens; `act` rounds every product's activations."""
    seqs = [torch.tensor(list(p) + list(s[:-1]), dtype=torch.long,
                         device=device) for p, s in requests]
    xs = [dequant(weights["token_embd.weight"], t) for t in seqs]
    for i in range(m.layers):
        w = {p: dequant(weights[f"blk.{i}.{p}.weight"])
             for p in (*PROJECTIONS, "attn_norm", "ffn_norm")}
        for j, t in enumerate(seqs):
            x = xs[j]
            pos = torch.arange(len(t), device=device)
            h = act(rms_norm(x, m.eps, w["attn_norm"]))
            q = (h @ w["attn_q"].T).reshape(len(t), m.heads, m.head_dim)
            k = (h @ w["attn_k"].T).reshape(len(t), m.kv_heads, m.head_dim)
            v = (h @ w["attn_v"].T).reshape(len(t), m.kv_heads, m.head_dim)
            q, k = rope_norm(q, pos, m.theta), rope_norm(k, pos, m.theta)
            o = attention(m, q, int8_rows(k), int8_rows(v))
            x = x + act(o) @ w["attn_output"].T
            h = act(rms_norm(x, m.eps, w["ffn_norm"]))
            gate, up = h @ w["ffn_gate"].T, h @ w["ffn_up"].T
            xs[j] = x + act(torch.nn.functional.silu(gate) * up) @ w["ffn_down"].T
        del w
    head = dequant(weights["token_embd.weight" if m.tied else "output.weight"])
    norm = dequant(weights["output_norm.weight"])
    return [act(rms_norm(x[len(p) - 1:], m.eps, norm)) @ head.T
            for (p, _), x in zip(requests, xs)]
