"""Fused dequantize+matmul for Q8_0 weights: kernel K10 and its plain version.

C = (A @ B.T).T for Q8_0 weights A (M, K), K a multiple of 32, and float
activations B (N, K): output (N, M) float32. The element value d*q (an
fp16 d per 32-block times an int8 q) is exact in f32. "high" keeps f32
operands; "fast" rounds both b and d*q to bf16 before the f32-accumulated
product. `act_quant=True` fake-quantizes the activations to Q8_1 first
(K6) at any width and in both precisions, as the JAX package does (default
False, see `mmq_q4_k`). Counterpart of `gguf_tpu/ops/mmq_q8_0.py:mmq_q8_0`
(Pallas `_kernel`, `_kernel_plane`, `_kernel_ink`; the plane order and
in-kernel permutes are TPU glue, the port keeps natural element order);
the CUDA source is `gguf_tpu_torch/csrc/mmq_q8_0.cu` over the tile in
`csrc/block32.cuh`, shared with K11 (`mmq_legacy`).

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K10 or raises. `mmq_q8_0.launches` counts K10 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.layouts import QuantWeight
from . import build
from .activation import fake_quant_2d
from .mmq_q4_k import check_operands, check_precision, matmul_plain

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q8_0_launch": [_VP] * 5 + [_I] * 7 + [_VP]}
KT = 64             # K elements per step of the tile (csrc/mmq_common.cuh)
BM = 64             # output rows per block
MAX_SPLITS = 8


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(m: int, n: int, k: int, sms: int) -> tuple:
    """How the split-K kernels (K10-K14) cut K across the grid's z axis:
    (splits, K steps per split). Enough blocks for two per SM when M and
    N give too few (decode widths at M = 2048: 32 blocks), at most MAX_SPLITS;
    the partial sums are then added in split order by a second launch,
    so the result does not depend on the schedule."""
    bn = 8 if n <= 8 else 16 if n <= 16 else 64
    steps = -(-k // KT)
    blocks = -(-m // BM) * -(-n // bn)
    want = max(1, min(MAX_SPLITS, steps, -(-2 * sms // blocks)))
    per = -(-steps // want)
    return -(-steps // per), per


def launch_split_k(fn, w: QuantWeight, b: torch.Tensor, fields: list,
                   extra: tuple, precision: str, what: str) -> torch.Tensor:
    """Launch a split-K MMQ kernel (K10-K14) on validated CUDA operands:
    `fn(*fields, x, out, part, *extra, M, N, K, x_bf16, fast, splits,
    steps_per_split, stream)`; `fields` lists (tensor or None where the
    format has no such field, byte alignment the kernel's loads need)."""
    (m, k), n = w.shape, b.shape[0]
    b = b.contiguous()
    if any(f is not None and f.data_ptr() % a for f, a in fields):
        raise ValueError(f"{what}: misaligned weight fields")
    out = torch.empty((n, m), dtype=torch.float32, device=b.device)
    if n == 0:
        return out
    splits, per = split_k(m, n, k, _sms(b.device.index or 0))
    part = (torch.empty((splits, n, m), dtype=torch.float32, device=b.device)
            if splits > 1 else out)
    err = fn(*(None if f is None else build.ptr(f) for f, _ in fields),
             build.ptr(b), build.ptr(out),
             build.ptr(part), *extra, m, n, k, int(b.dtype == torch.bfloat16),
             int(precision == "fast"), splits, per, build.stream_ptr())
    build.check(err, what)
    return out


def format_wrapper(kernel, fmt: str, tag: str):
    """The public entry point of one format of a kernel that serves several
    (K11's `mmq_q4_0` .. `mmq_q5_1`, K14's `mmq_iq4_nl` / `mmq_iq4_xs`):
    it checks the weight's format and calls `kernel`, whose launch counter
    it shares."""
    def fn(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
           act_quant: bool = False) -> torch.Tensor:
        if w.fmt != fmt:
            raise ValueError(f"expected a {fmt} weight, got {w.fmt}")
        return kernel(w, b, precision=precision, act_quant=act_quant)

    fn.__name__ = fn.__qualname__ = f"mmq_{fmt}"
    fn.__doc__ = f"C = (A @ B.T).T for {fmt.upper()} weights ({tag})."
    return fn


def mmq_q8_0_plain(w: QuantWeight, b: torch.Tensor, *,
                   precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of K10 (any device)."""
    check_operands(w, b, "q8_0", None)
    return matmul_plain(b.float(), w.dequantize(), precision)


def _lib():
    return build.load("mmq_q8_0", _SIG)


def mmq_q8_0(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             act_quant: bool = False) -> torch.Tensor:
    """C = (A @ B.T).T for Q8_0 weights A (M, K) and B (N, K); (N, M) f32."""
    check_precision(precision)
    k = check_operands(w, b, "q8_0", None)
    if act_quant:
        b = fake_quant_2d(b, k, None)
    if b.device.type == "cpu":
        return mmq_q8_0_plain(w, b, precision=precision)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q8_0 runs on cpu or cuda, not {b.device}")
    out = launch_split_k(_lib().mmq_q8_0_launch, w, b,
                         [(w.fields["d"], 2), (w.fields["qs"], 16)], (),
                         precision, "mmq_q8_0")
    if b.shape[0]:
        mmq_q8_0.launches += 1
    return out


mmq_q8_0.launches = 0
