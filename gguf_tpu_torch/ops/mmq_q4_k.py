"""Fused dequantize+matmul for Q4_K weights (kernel K1) and the Q8_1
integer MMQ contract for Q4_K and Q5_K weights (kernel K7), each beside
its plain version.

C = (A @ B.T).T for Q4_K weights A (M, K) and float activations B (N, K):
output (N, M) float32. Counterpart of `gguf_tpu/ops/mmq_q4_k.py:mmq_q4_k`
(its Pallas bodies `_kernel_ink` at decode widths, `_kernel` at prefill
widths, `_kernel_i8` under act_quant); the CUDA sources are
`gguf_tpu_torch/csrc/mmq_q4_k.cu` (K1) and `mmq_i8.cu` (K7). K1 "fast"
runs on bf16 tensor cores (wgmma) and K7 on int8 ones (mma.sync), both
over the TMA-fed tile of `csrc/mmq_tc.cuh`; K1 "high" runs the SIMT f32
tile of `csrc/kquant.cuh`; K8 (`mmq_q5_k`) runs both tiles too. Their
wrappers pick the split of K (`k1_plan`, `split_k`) and allocate its
scratch; `launch_tc` does the same for the "fast" tensor-core tiles of K2
(`mmq_q6_k`), K8, K11 (`mmq_legacy`), K12 (`mmq_q2_k`), K13 (`mmq_q3_k`)
and K14 (`mmq_iq4`).

`precision="fast"` rounds both operands to bf16 before the f32-accumulated
product (the TPU's single-pass bf16 MXU contract); "high" keeps f32.
`glu="silu"|"gelu"` takes the raw fused gate_up output (N, 2K) and uses
h = act(gate) * up, computed in f32 (then rounded to bf16 under "fast"),
as the activation — at every width, one formula.

`act_quant=True` feeds llama.cpp's Q8_1 activations, routed as the JAX
package routes them: under "high" at n <= 16 the codes (K5) go to the
integer contract (K7); otherwise the fake-quantized activations (K6) go
to the float kernel. With `glu`, h is quantized unrounded. The default
is False here, unlike the JAX op's True, so a call without the keyword
keeps bf16 activations; `linear` and `mlp` pass `MMOpts.act_quant`.

On a CPU tensor the wrappers run the plain PyTorch versions; on a CUDA
tensor they launch the kernel or raise. `mmq_q4_k.launches` counts K1
launches and `mmq_i8.launches` K7 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.layouts import QuantWeight, kquant_parts
from . import build
from .activation import GLU_CODES, codes_2d, fake_quant_2d, glu_plain

I8_MAX_N = 16         # the JAX package's n gate for the integer contract
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q4_k_launch": [_VP] * 5 + [_I] * 9 + [_VP]}
_SIG_I8 = {"mmq_i8_launch": [_VP] * 6 + [_I] * 6 + [_VP]}
KT = 64             # K elements per step of the SIMT tiles (mmq_common.cuh)
                    # and per chunk of K1's tensor-core tile (mmq_tc.cuh)
I8_KT = 128         # K elements per chunk of K7 (csrc/mmq_i8.cu)
KH = 128            # per chunk of K2's and K12's tensor-core tiles
BM = 64             # output rows per block
MAX_SPLITS = 8


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tc_tile(n: int) -> tuple:
    """(weight rows, activation rows) of K1's "fast" tensor-core tile for n
    activation rows (csrc/mmq_q4_k.cu picks the same): one warpgroup of 64
    rows at n <= 64, two sharing each activation tile above."""
    return (64, 8) if n <= 8 else (64, 16) if n <= 16 else \
        (64, 64) if n <= 64 else (128, 128)


@functools.lru_cache(maxsize=4096)
def split_k(m: int, n: int, k: int, sms: int, tile: tuple | None = None,
            per_sm: int = 2, kt: int = KT) -> tuple:
    """How the split-K kernels (K1, K2, K8 and K10-K14 "fast", K7,
    K10-K14 "high") cut K across the grid's z axis: (splits, K steps of `kt` per
    split), for a tile of (rows, width) = `tile`, by default (BM, 8, 16 or
    64 from n). Enough blocks for `per_sm` per SM when M and N give too
    few (decode widths at M = 2048: 32 blocks), at most MAX_SPLITS; the
    partial sums are then added in split order by a second launch, so the
    result does not depend on the schedule (`k1_plan` asks for 4 per SM
    at decode widths). Cached per shape: every call of a wrapper asks."""
    bm, bn = tile or (BM, 8 if n <= 8 else 16 if n <= 16 else 64)
    steps = -(-k // kt)
    blocks = -(-m // bm) * -(-n // bn)
    want = max(1, min(MAX_SPLITS, steps, -(-per_sm * sms // blocks)))
    per = -(-steps // want)
    return -(-steps // per), per


def split_scratch(splits: int, n: int, m: int,
                  out: torch.Tensor) -> torch.Tensor:
    """The (splits, n, m) f32 partial tiles of a split-K launch, or `out`
    itself when K is not split."""
    if splits == 1:
        return out
    return torch.empty((splits, n, m), dtype=torch.float32, device=out.device)


def tc_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """(splits, chunks per split) of the "fast" tensor-core tiles of K2 and
    K10-K14 (KH-element chunks, the tile `tc_tile(n)`), 2 blocks
    per SM asked at every width: the 32000-row head (500 row blocks) is not
    split, where 4 per SM would split it in two and add a partial-sum
    pass."""
    return split_k(m, n, k, sms, tc_tile(n), 2, KH)


def k1_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """(splits, chunks per split) of K1's and K8's "fast" tensor-core tile
    (KT-element chunks, the tile `tc_tile(n)`): 4 blocks per SM asked at
    decode widths, where its blocks are small and hide latency with more of
    them, 2 above."""
    return split_k(m, n, k, sms, tc_tile(n), 4 if n <= 16 else 2)


def launch_tc(fn, w: QuantWeight, b: torch.Tensor, fields: list,
              what: str, extra: tuple = (), plan=tc_plan,
              bsum: bool = False) -> torch.Tensor:
    """Launch a "fast" tensor-core tile (K2, K8, K10-K14) on validated CUDA
    operands: `fn(*fields, x, xb, [bsum,] out, part, *extra, M, N, K,
    x_bf16, splits, chunks_per_split, stream)`, `fields` listing (tensor or
    None where the format has no such field, the byte alignment its loads
    need: 16 for a TMA box), K split as `plan(M, N, K, SMs)` says. The
    kernel takes a bf16 (N, K) operand: b itself, or scratch it fills
    first; with `bsum` (K11's correction term) also (N, K/32) f32 scratch
    for the sums of b's blocks when it fills that operand, else None."""
    (m, k), n = w.shape, b.shape[0]
    b = b.contiguous()
    if any(f is not None and (not f.is_contiguous() or f.data_ptr() % a)
           for f, a in fields):
        raise ValueError(f"{what}: weight fields must be contiguous and "
                         "aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=b.device)
    if n == 0:
        return out
    splits, per = plan(m, n, k, sm_count(b.device.index or 0))
    direct = b.dtype == torch.bfloat16 and b.data_ptr() % 16 == 0
    xb = b if direct else torch.empty((n, k), dtype=torch.bfloat16,
                                      device=b.device)
    sums = torch.empty((n, k // 32), dtype=torch.float32, device=b.device) \
        if bsum and not direct else None
    err = fn(*(None if f is None else build.ptr(f) for f, _ in fields),
             build.ptr(b), build.ptr(xb),
             *((None if sums is None else build.ptr(sums),) if bsum else ()),
             build.ptr(out),
             build.ptr(split_scratch(splits, n, m, out)), *extra, m, n, k,
             int(b.dtype == torch.bfloat16), splits, per, build.stream_ptr())
    build.check(err, what)
    return out


def check_operands(w: QuantWeight, b: torch.Tensor, fmt: str, glu) -> int:
    """Validate an MMQ call; returns K."""
    if w.fmt != fmt:
        raise ValueError(f"expected a {fmt} weight, got {w.fmt}")
    if glu not in GLU_CODES:
        raise ValueError(f"glu must be one of {list(GLU_CODES)}, got {glu!r}")
    m, k = w.shape
    want = 2 * k if glu else k
    if b.dim() != 2 or b.shape[1] != want:
        raise ValueError(f"activations {tuple(b.shape)} do not match "
                         f"weight {w.shape} (glu={glu})")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {b.dtype}")
    if b.device != w.device:
        raise ValueError(f"weight on {w.device}, activations on {b.device}")
    return k


def check_precision(precision: str) -> None:
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got {precision!r}")


def dequantize_q4_k_plain(w: QuantWeight) -> torch.Tensor:
    """(M, K) float32 in torch ops on the weight's device, bit-equal to
    the JAX package's dequantize (x = (d*sc)*q - dmin*mn)."""
    if w.fmt != "q4_k":
        raise ValueError(f"expected a q4_k weight, got {w.fmt}")
    return w.dequantize()


def matmul_plain(x: torch.Tensor, wf: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """x (N, K) f32 @ wf (M, K)^T with the kernels' rounding contract."""
    if precision == "fast":
        x = x.bfloat16().float()
        wf = wf.bfloat16().float()
    return x @ wf.T


def mmq_q4_k_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high", glu: str | None = None
                   ) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device)."""
    check_operands(w, b, "q4_k", glu)
    x = glu_plain(b, glu) if glu else b.float()
    return matmul_plain(x, dequantize_q4_k_plain(w), precision)


def _lib():
    return build.load("mmq_q4_k", _SIG)


def _mmq_q4_k_float(w: QuantWeight, b: torch.Tensor, precision: str,
                    glu: str | None = None) -> torch.Tensor:
    """K1 on validated CUDA operands, its plain version on CPU ones."""
    if b.device.type == "cpu":
        return mmq_q4_k_plain(w, b, precision=precision, glu=glu)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q4_k runs on cpu or cuda, not {b.device}")
    (m, k), n = w.shape, b.shape[0]
    b = b.contiguous()
    blocks = w.fields["blocks"]
    if blocks.data_ptr() % 16:
        raise ValueError("Q4_K blocks must be 16-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=b.device)
    if n == 0:
        return out
    fast = precision == "fast"
    splits, per = (k1_plan(m, n, k, sm_count(b.device.index or 0))
                   if fast else (1, 1))
    # "fast" takes a bf16 (N, K) operand: b itself, or scratch the kernel
    # fills first (bf16(b), or bf16(act(gate) * up) with glu)
    direct = (b.dtype == torch.bfloat16 and glu is None
              and b.data_ptr() % 16 == 0)
    xb = b if direct or not fast else torch.empty(
        (n, k), dtype=torch.bfloat16, device=b.device)
    err = _lib().mmq_q4_k_launch(
        build.ptr(blocks), build.ptr(b), build.ptr(out),
        build.ptr(split_scratch(splits, n, m, out)), build.ptr(xb), m, n, k,
        b.shape[1], int(b.dtype == torch.bfloat16), GLU_CODES[glu], int(fast),
        splits, per, build.stream_ptr())
    build.check(err, "mmq_q4_k")
    mmq_q4_k.launches += 1
    return out


def route_act_quant(w: QuantWeight, b: torch.Tensor, precision: str,
                    glu: str | None, float_fn) -> torch.Tensor:
    """llama.cpp's Q8_1 activations for validated Q4_K/Q5_K operands,
    routed as the JAX package routes them: under "high" at n <= 16 the
    codes (K5) go to the integer contract (K7); otherwise the
    fake-quantized activations (K6) go to `float_fn(w, b, precision)`,
    the format's float kernel. With `glu`, h = act(gate) * up is quantized
    unrounded."""
    k = w.shape[1]
    if precision == "high" and b.shape[0] <= I8_MAX_N:
        return _mmq_i8(w, *codes_2d(b, k, glu))
    return float_fn(w, fake_quant_2d(b, k, glu), precision)


def mmq_q4_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             glu: str | None = None, act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q4_K weights A (M, K) and B (N, K) [(N, 2K)
    with `glu`]; returns (N, M) float32."""
    check_precision(precision)
    check_operands(w, b, "q4_k", glu)
    if act_quant:
        return route_act_quant(w, b, precision, glu, _mmq_q4_k_float)
    return _mmq_q4_k_float(w, b, precision, glu)


mmq_q4_k.launches = 0


# ------------------------------------------------- K7: Q8_1 integer MMQ ---


def _check_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
              s: torch.Tensor) -> int:
    if w.fmt not in ("q4_k", "q5_k"):
        raise ValueError(f"mmq_i8 takes q4_k or q5_k weights, got {w.fmt}")
    m, k = w.shape
    n = q.shape[0]
    if q.dtype != torch.int8 or q.shape != (n, k):
        raise ValueError(f"codes must be int8 ({n}, {k}), got "
                         f"{q.dtype} {tuple(q.shape)}")
    for t in (d, s):
        if t.dtype != torch.float32 or t.shape != (n, k // 32):
            raise ValueError(f"d and s must be float32 ({n}, {k // 32})")
    if any(t.device != w.device for t in (q, d, s)):
        raise ValueError("weight, codes and scales must share a device")
    return n


def mmq_i8_plain(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (any device, any n). The per-32-block
    partials come from an f32 batched matmul, exact because
    |partial| <= 32 * 127 * 31 < 2^24 (TF32 must be off on a GPU)."""
    n = _check_i8(w, q, d, s)
    m, k = w.shape
    nb = k // 32
    scale, minv, codes = kquant_parts(w)
    p = torch.bmm(q.float().view(n, nb, 32).transpose(0, 1),
                  codes.view(m, nb, 32).permute(1, 2, 0))       # (nb, n, M)
    c = ((p * d.T[:, :, None]) * scale.view(m, nb).T[:, None, :]).sum(dim=0)
    return c - s @ minv.view(m, nb).T


def _lib_i8():
    return build.load("mmq_i8", _SIG_I8)


def mmq_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """llama.cpp's integer MMQ: Q4_K/Q5_K weights (M, K) x Q8_1 activation
    codes q (n, K) int8 with their d and s (n, K/32) f32, n <= 16;
    returns (n, M) float32."""
    n = _check_i8(w, q, d, s)
    if q.device.type == "cuda" and n > I8_MAX_N:
        raise ValueError(f"mmq_i8 takes at most {I8_MAX_N} activation rows, "
                         f"got {n}")
    return _mmq_i8(w, q, d, s)


def _mmq_i8(w: QuantWeight, q: torch.Tensor, d: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """K7 on validated CUDA operands (n <= 16), its plain version on CPU
    ones."""
    if q.device.type == "cpu":
        return mmq_i8_plain(w, q, d, s)
    if q.device.type != "cuda":
        raise ValueError(f"mmq_i8 runs on cpu or cuda, not {q.device}")
    (m, k), n = w.shape, q.shape[0]
    q, d, s = q.contiguous(), d.contiguous(), s.contiguous()
    blocks = w.fields["blocks"]
    if any(t.data_ptr() % 16 for t in (blocks, q, d, s)):
        raise ValueError("mmq_i8: weight blocks, codes, d and s must be "
                         "16-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    splits, per = split_k(m, n, k, sm_count(q.device.index or 0), kt=I8_KT)
    err = _lib_i8().mmq_i8_launch(
        build.ptr(blocks), build.ptr(q), build.ptr(d), build.ptr(s),
        build.ptr(out), build.ptr(split_scratch(splits, n, m, out)), m, n, k,
        int(w.fmt == "q5_k"), splits, per, build.stream_ptr())
    build.check(err, "mmq_i8")
    mmq_i8.launches += 1
    return out


mmq_i8.launches = 0
