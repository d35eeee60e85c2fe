"""Quantized weights of the port: GGUF block bytes on the device
(`QuantWeight`, dequantized in torch) and the quantizers the checkpoint
writer uses (numpy for the 32-element-block and IQ4 formats, the port's
own C core for Q2_K/Q3_K/Q4_K/Q5_K/Q6_K)."""

from .layouts import QuantWeight, concat_m
from .iq4 import quantize_iq4_nl, quantize_iq4_xs
from .legacy import quantize_q4_0, quantize_q4_1, quantize_q5_0, quantize_q5_1
from .native import (quantize_q2_k, quantize_q3_k, quantize_q4_k,
                     quantize_q5_k, quantize_q6_k)
from .q8_0 import quantize_q8_0

# format name -> float array -> flat GGUF block bytes
QUANTIZERS = {"q2_k": quantize_q2_k, "q3_k": quantize_q3_k,
              "q4_k": quantize_q4_k, "q5_k": quantize_q5_k,
              "q6_k": quantize_q6_k, "q8_0": quantize_q8_0,
              "q4_0": quantize_q4_0, "q4_1": quantize_q4_1,
              "q5_0": quantize_q5_0, "q5_1": quantize_q5_1,
              "iq4_nl": quantize_iq4_nl, "iq4_xs": quantize_iq4_xs}

__all__ = ["QuantWeight", "concat_m", "QUANTIZERS", *sorted(
    f"quantize_{f}" for f in QUANTIZERS)]
