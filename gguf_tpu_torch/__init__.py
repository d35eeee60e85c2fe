"""gguf_tpu_torch — the PyTorch/CUDA port of `gguf_tpu` for NVIDIA Hopper.

The JAX package `gguf_tpu` stays the reference; this package keeps its
module names so each piece has an obvious counterpart:

- `gguf_tpu_torch.quant`  — `QuantWeight`: GGUF block bytes as stored, on
                            the device (no TPU structure-of-arrays layout)
- `gguf_tpu_torch.ops`    — hand-written sm_90a CUDA kernels (MMQ for Q4_K
                            and Q6_K, INT8 KV-cache insert, decode
                            attention), each beside its plain PyTorch version
- `gguf_tpu_torch.models` — config, GGUF loader, Llama forward
- `gguf_tpu_torch.engine` — sampler and the continuous-batching `LLM`

Import boundary: this package imports `torch`, never `jax`. It reuses the
framework-neutral parts of `gguf_tpu` (`gguf_tpu.gguf`, the codecs in
`gguf_tpu.quant`, and `gguf_tpu/models/config.py` loaded by file path),
none of which import jax.
"""

__version__ = "0.1.0"
