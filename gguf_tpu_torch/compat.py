"""Reference-compatible kernel entry points.

The upstream reference exposes `mmq_q8_0(A, B, M, N, K)`, `mmq_q4_k` and
`mmq_q6_k`, taking raw GGUF weight bytes and (N, K) activations and
returning C = (A @ B.T).T of shape (N, M). The port's own copy of
`gguf_tpu/compat.py` keeps that calling convention (and `mmq_q2_k`,
`mmq_q3_k`, `mmq_q5_k`): each call wraps the bytes in a `QuantWeight` on
`device` (the card unless the caller asks for the CPU) and dispatches to
the port's MMQ kernel. As in
the reference, the activations are quantized to Q8_1 first
(`act_quant=True`) and `precision` is "high" unless the keywords say
otherwise.

For anything beyond a one-off call, build the `QuantWeight` once and call
`gguf_tpu_torch.ops.MMQ[fmt]`: this module copies the bytes to the device
on every call.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import MMQ
from .quant.layouts import QuantWeight


def _mmq(fmt: str, a, b, m: int, n: int, k: int, device="cuda",
         **kw) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    w = QuantWeight.from_blocks(fmt, np.asarray(a), (m, k), device)
    b = torch.as_tensor(b).to(device=device, dtype=torch.float32).reshape(n, k)
    kw.setdefault("act_quant", True)
    return MMQ[fmt](w, b, **kw)


def mmq_q8_0(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q8_0 weight bytes (M rows x K cols) x float (N, K) -> (N, M).
    K % 32 == 0."""
    return _mmq("q8_0", a, b, m, n, k, **kw)


def mmq_q4_k(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q4_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q4_k", a, b, m, n, k, **kw)


def mmq_q5_k(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q5_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q5_k", a, b, m, n, k, **kw)


def mmq_q6_k(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q6_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q6_k", a, b, m, n, k, **kw)


def mmq_q2_k(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q2_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q2_k", a, b, m, n, k, **kw)


def mmq_q3_k(a, b, m: int, n: int, k: int, **kw) -> torch.Tensor:
    """Q3_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q3_k", a, b, m, n, k, **kw)
