"""Q8_1 activation quantization: kernels K5 (codes) and K6 (fake-quant),
each beside its plain PyTorch version, and the gated-MLP activation.

Counterpart of `gguf_tpu/ops/activation.py`: `quantize_q8_1_codes`
(Pallas `_codes_kernel`) and `fake_quantize_q8_1` (Pallas `_fq_kernel` at
n <= 64, the XLA chain `quantize_q8_1_act` above that; both compute the
same values). The CUDA source is `gguf_tpu_torch/csrc/activation.cu`.

Per 32-element block of a row, with every fp16 rounding point of the JAX
package (round to nearest even, computed in f32):

    g = fp16(x); amax = max|g|; d = fp16(amax / 127)
    q = clip(rint(fp16(g / d_safe)), -127, 127), d_safe = d or 1 if d == 0
    s = fp16(d * sum(q))              (the sum is exact)

`s` follows the JAX package, which the port is held against. The numpy
codec `gguf_tpu/quant/q8_1.py` rounds sum(q) to fp16 before the product
(s = fp16(d * fp16(sum(q)))), which differs once |sum(q)| > 2048.

`glu="silu"|"gelu"` takes the raw fused gate_up output (N, 2K) and
quantizes h = act(gate) * up, computed in f32 and not rounded to bf16
(`gguf_tpu/ops/mmq_q4_k.py:mmq_q4_k` under act_quant).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch K5 / K6 or raise. `quantize_q8_1_codes.launches` counts K5
launches and `fake_quantize_q8_1.launches` K6 launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

BLOCK = 32
GLU_CODES = {None: 0, "silu": 1, "gelu": 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"quantize_q8_1_launch": [_VP] * 4 + [_I] * 5 + [_VP],
        "fake_quantize_q8_1_launch": [_VP] * 2 + [_I] * 5 + [_VP]}


def glu_plain(b: torch.Tensor, glu: str | None) -> torch.Tensor:
    """(N, 2K) raw gate_up -> h = act(gate) * up in float32."""
    g, u = b.float().chunk(2, dim=-1)
    act = F.silu(g) if glu == "silu" else F.gelu(g, approximate="tanh")
    return act * u


def _fp16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest fp16 value (ties to even), kept as f32."""
    return x.half().float()


def _rows(x: torch.Tensor, glu: str | None) -> tuple:
    """Validate an (..., K) activation [(..., 2K) with glu]; returns
    (lead shape, K)."""
    if glu not in GLU_CODES:
        raise ValueError(f"glu must be one of {list(GLU_CODES)}, got {glu!r}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {x.dtype}")
    k = x.shape[-1] // 2 if glu else x.shape[-1]
    if k % BLOCK or (glu and x.shape[-1] != 2 * k):
        raise ValueError(f"activations {tuple(x.shape)}: K must be a multiple "
                         f"of {BLOCK} (glu={glu})")
    return tuple(x.shape[:-1]), k


def _codes_plain(x: torch.Tensor, glu: str | None):
    """(n, K) -> q (float codes), d, s, all float32."""
    h = glu_plain(x, glu) if glu else x.float()
    n, k = h.shape
    g = _fp16(h).view(n, k // BLOCK, BLOCK)
    amax = g.abs().amax(dim=-1)
    d = _fp16(amax / 127.0)
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    q = torch.clamp(torch.round(_fp16(g / d_safe[..., None])), -127, 127)
    s = _fp16(d * q.sum(dim=-1))
    return q, d, s


def quantize_q8_1_codes_plain(x: torch.Tensor, *, glu: str | None = None):
    """Plain PyTorch version of K5 (any device)."""
    lead, k = _rows(x, glu)
    q, d, s = _codes_plain(x.reshape(-1, x.shape[-1]), glu)
    return (q.to(torch.int8).view(*lead, k), d.view(*lead, k // BLOCK),
            s.view(*lead, k // BLOCK))


def fake_quantize_q8_1_plain(x: torch.Tensor, *,
                             glu: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of K6 (any device)."""
    lead, k = _rows(x, glu)
    q, d, _ = _codes_plain(x.reshape(-1, x.shape[-1]), glu)
    return (q * d[..., None]).view(*lead, k)


def _lib():
    return build.load("activation", _SIG)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"Q8_1 quantization runs on cpu or cuda, not {x.device}")


def codes_2d(x: torch.Tensor, k: int, glu: str | None):
    """K5 on a validated 2-D (n, K) [(n, 2K) with `glu`] CUDA tensor, its
    plain version on a CPU one: q int8 (n, K), d and s f32 (n, K/32). The
    MMQ wrappers call this after their own operand checks."""
    if x.device.type == "cpu":
        q, d, s = _codes_plain(x, glu)
        return q.to(torch.int8).view(x.shape[0], k), d, s
    _check_device(x)
    x = x.contiguous()
    n = x.shape[0]
    q = torch.empty((n, k), dtype=torch.int8, device=x.device)
    d = torch.empty((n, k // BLOCK), dtype=torch.float32, device=x.device)
    s = torch.empty_like(d)
    if n:
        err = _lib().quantize_q8_1_launch(
            build.ptr(x), build.ptr(q), build.ptr(d), build.ptr(s), n, k,
            x.shape[1], int(x.dtype == torch.bfloat16), GLU_CODES[glu],
            build.stream_ptr())
        build.check(err, "quantize_q8_1_codes")
        quantize_q8_1_codes.launches += 1
    return q, d, s


def fake_quant_2d(x: torch.Tensor, k: int, glu: str | None) -> torch.Tensor:
    """K6 on a validated 2-D CUDA tensor (as `codes_2d`), its plain version
    on a CPU one: f32 (n, K)."""
    if x.device.type == "cpu":
        q, d, _ = _codes_plain(x, glu)
        return (q * d[..., None]).view(x.shape[0], k)
    _check_device(x)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n:
        err = _lib().fake_quantize_q8_1_launch(
            build.ptr(x), build.ptr(out), n, k, x.shape[1],
            int(x.dtype == torch.bfloat16), GLU_CODES[glu],
            build.stream_ptr())
        build.check(err, "fake_quantize_q8_1")
        fake_quantize_q8_1.launches += 1
    return out


def quantize_q8_1_codes(x: torch.Tensor, *, glu: str | None = None):
    """Q8_1-quantize (..., K) activations [(..., 2K) raw gate_up with
    `glu`]: (q int8 (..., K), d f32 (..., K/32), s f32 (..., K/32))."""
    lead, k = _rows(x, glu)
    q, d, s = codes_2d(x.reshape(-1, x.shape[-1]), k, glu)
    return (q.view(*lead, k), d.view(*lead, k // BLOCK),
            s.view(*lead, k // BLOCK))


def fake_quantize_q8_1(x: torch.Tensor, *,
                       glu: str | None = None) -> torch.Tensor:
    """Round-trip (..., K) activations [(..., 2K) with `glu`] through Q8_1:
    float32 q * d of the same shape as the codes."""
    lead, k = _rows(x, glu)
    return fake_quant_2d(x.reshape(-1, x.shape[-1]), k, glu).view(*lead, k)


quantize_q8_1_codes.launches = 0
fake_quantize_q8_1.launches = 0
