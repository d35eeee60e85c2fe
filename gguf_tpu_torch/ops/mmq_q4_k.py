"""Fused dequantize+matmul for Q4_K weights: kernel K1 and its plain version.

C = (A @ B.T).T for Q4_K weights A (M, K) and float activations B (N, K):
output (N, M) float32. Counterpart of `gguf_tpu/ops/mmq_q4_k.py:mmq_q4_k`
(its Pallas bodies `_kernel_ink` at decode widths and `_kernel` at prefill
widths); the CUDA source is `gguf_tpu_torch/csrc/mmq_q4_k.cu`.

`precision="fast"` rounds both operands to bf16 before the f32-accumulated
product (the TPU's single-pass bf16 MXU contract); "high" keeps f32.
`glu="silu"|"gelu"` takes the raw fused gate_up output (N, 2K) and uses
h = act(gate) * up, computed in f32 (then rounded to bf16 under "fast"),
as the activation — at every width, one formula.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches K1 or raises. `mmq_q4_k.launches` counts K1 launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..quant.layouts import QK_K, QuantWeight
from . import build

GLU_CODES = {None: 0, "silu": 1, "gelu": 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"mmq_q4_k_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP]}


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


def glu_plain(b: torch.Tensor, glu: str | None) -> torch.Tensor:
    """(N, 2K) raw gate_up -> h = act(gate) * up in float32."""
    g, u = b.float().chunk(2, dim=-1)
    act = F.silu(g) if glu == "silu" else F.gelu(g, approximate="tanh")
    return act * u


def dequantize_q4_k_plain(w: QuantWeight) -> torch.Tensor:
    """(M, K) float32 from the GGUF bytes in torch ops on the weight's own
    device; same float op order as `gguf_tpu.quant.dequantize_q4_k`
    (x = (d*sc)*q - dmin*mn), so bit-equal to it."""
    m, k = w.shape
    sb = k // QK_K
    blk = w.fields["blocks"].view(m, sb, 144)
    d = blk[:, :, 0:2].contiguous().view(torch.float16).float()
    dmin = blk[:, :, 2:4].contiguous().view(torch.float16).float()
    s = blk[:, :, 4:16].int()
    a, bb, c = s[..., 0:4], s[..., 4:8], s[..., 8:12]
    sc = torch.cat([a & 63, (c & 15) | ((a >> 6) << 4)], dim=-1).float()
    mn = torch.cat([bb & 63, (c >> 4) | ((bb >> 6) << 4)], dim=-1).float()
    qv = blk[:, :, 16:].int().view(m, sb, 4, 1, 32)
    q = torch.cat([qv & 15, qv >> 4], dim=3).view(m, sb, 8, 32).float()
    x = (d * sc)[..., None] * q - (dmin * mn)[..., None]
    return x.view(m, k)


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


def mmq_q4_k(w: QuantWeight, b: torch.Tensor, *, precision: str = "high",
             glu: str | None = None) -> torch.Tensor:
    """C = (A @ B.T).T for Q4_K weights A (M, K) and B (N, K) [(N, 2K)
    with `glu`]; returns (N, M) float32."""
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got {precision!r}")
    if b.device.type == "cpu":
        return mmq_q4_k_plain(w, b, precision=precision, glu=glu)
    if b.device.type != "cuda":
        raise ValueError(f"mmq_q4_k runs on cpu or cuda, not {b.device}")
    k = check_operands(w, b, "q4_k", glu)
    m, n = w.shape[0], b.shape[0]
    b = b.contiguous()
    blocks = w.fields["blocks"]
    if blocks.data_ptr() % 16:
        raise ValueError("Q4_K blocks must be 16-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=b.device)
    if n == 0:
        return out
    err = _lib().mmq_q4_k_launch(
        build.ptr(blocks), build.ptr(b), build.ptr(out), m, n, k,
        b.shape[1], int(b.dtype == torch.bfloat16), GLU_CODES[glu],
        int(precision == "fast"), build.stream_ptr())
    build.check(err, "mmq_q4_k")
    mmq_q4_k.launches += 1
    return out


mmq_q4_k.launches = 0
