"""The port's kernels (hand-written CUDA for sm_90a), each beside its plain
PyTorch version, and the MMQ dispatch table."""

from .activation import fake_quantize_q8_1, quantize_q8_1_codes
from .attention import (decode_attention, decode_attention_tiled,
                        decode_attention_update, kv_cache_insert)
from .mmq_q4_k import mmq_i8, mmq_q4_k
from .mmq_q5_k import mmq_q5_k
from .mmq_q6_k import mmq_q6_k


class _MMQ(dict):
    """Format -> MMQ wrapper. Formats without a Hopper kernel yet raise."""

    def __missing__(self, fmt):
        raise NotImplementedError(
            f"no MMQ kernel for {fmt!r} in gguf_tpu_torch yet: see "
            "ROADMAP.md, queue 2 (TPU kernels still to port)")


MMQ = _MMQ(q4_k=mmq_q4_k, q5_k=mmq_q5_k, q6_k=mmq_q6_k)

__all__ = ["MMQ", "mmq_q4_k", "mmq_q5_k", "mmq_q6_k", "mmq_i8",
           "quantize_q8_1_codes", "fake_quantize_q8_1", "kv_cache_insert",
           "decode_attention", "decode_attention_tiled",
           "decode_attention_update"]
