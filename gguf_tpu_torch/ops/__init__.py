"""The port's kernels (hand-written CUDA for sm_90a), each beside its plain
PyTorch version, and the MMQ dispatch table."""

from .attention import (decode_attention, decode_attention_update,
                        kv_cache_insert)
from .mmq_q4_k import mmq_q4_k
from .mmq_q6_k import mmq_q6_k


class _MMQ(dict):
    """Format -> MMQ wrapper. Formats without a Hopper kernel yet raise."""

    def __missing__(self, fmt):
        raise NotImplementedError(
            f"no MMQ kernel for {fmt!r} in gguf_tpu_torch yet: see "
            "ROADMAP.md, queue 2 (TPU kernels still to port)")


MMQ = _MMQ(q4_k=mmq_q4_k, q6_k=mmq_q6_k)

__all__ = ["MMQ", "mmq_q4_k", "mmq_q6_k", "kv_cache_insert",
           "decode_attention", "decode_attention_update"]
