"""The port's kernels (hand-written CUDA for sm_90a), each beside its plain
PyTorch version, and the MMQ dispatch table."""

from .activation import fake_quantize_q8_1, quantize_q8_1_codes, rms_norm
from .attention import (decode_attention, decode_attention_tiled,
                        decode_attention_update, kv_cache_insert)
from .mmq_iq4 import mmq_iq4, mmq_iq4_nl, mmq_iq4_xs
from .mmq_legacy import mmq_legacy, mmq_q4_0, mmq_q4_1, mmq_q5_0, mmq_q5_1
from .mmq_q2_k import mmq_q2_k
from .mmq_q3_k import mmq_q3_k
from .mmq_q4_k import mmq_i8, mmq_q4_k
from .mmq_q5_k import mmq_q5_k
from .mmq_q6_k import mmq_q6_k
from .mmq_q8_0 import mmq_q8_0


class _MMQ(dict):
    """Format -> MMQ wrapper. A format without a kernel raises."""

    def __missing__(self, fmt):
        raise NotImplementedError(
            f"no MMQ kernel for {fmt!r}: gguf_tpu_torch has them for "
            f"{sorted(self)}")


MMQ = _MMQ(q2_k=mmq_q2_k, q3_k=mmq_q3_k, q4_k=mmq_q4_k, q5_k=mmq_q5_k,
           q6_k=mmq_q6_k, q8_0=mmq_q8_0, q4_0=mmq_q4_0, q4_1=mmq_q4_1,
           q5_0=mmq_q5_0, q5_1=mmq_q5_1, iq4_nl=mmq_iq4_nl,
           iq4_xs=mmq_iq4_xs)

__all__ = ["MMQ", "mmq_q2_k", "mmq_q3_k", "mmq_q4_k", "mmq_q5_k",
           "mmq_q6_k", "mmq_q8_0", "mmq_legacy", "mmq_q4_0", "mmq_q4_1",
           "mmq_q5_0", "mmq_q5_1", "mmq_iq4", "mmq_iq4_nl", "mmq_iq4_xs",
           "mmq_i8", "quantize_q8_1_codes", "fake_quantize_q8_1", "rms_norm",
           "kv_cache_insert", "decode_attention", "decode_attention_tiled",
           "decode_attention_update"]
