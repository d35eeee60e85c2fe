"""gguf_tpu_torch — the PyTorch/CUDA port of `gguf_tpu` for NVIDIA Hopper.

The JAX package `gguf_tpu` stays the reference; this package keeps its
module names so each piece has an obvious counterpart:

- `gguf_tpu_torch.gguf`   — GGUF reader, writer and constants
- `gguf_tpu_torch.quant`  — `QuantWeight`: GGUF block bytes as stored, on
                            the device (no TPU structure-of-arrays layout),
                            dequantized in torch; the quantizers the
                            checkpoint writer uses (numpy, and a C core for
                            the K-quants built with gcc at first use)
- `gguf_tpu_torch.ops`    — hand-written sm_90a CUDA kernels (MMQ for Q4_K,
                            Q5_K, Q6_K, Q8_0 and Q4_0/Q4_1/Q5_0/Q5_1, the
                            Q8_1 activation contract, INT8 KV-cache insert,
                            decode attention), each beside its plain
                            PyTorch version
- `gguf_tpu_torch.models` — config, GGUF loader, Llama forward
- `gguf_tpu_torch.engine` — sampler and the continuous-batching `LLM`
- `gguf_tpu_torch.eval`   — perplexity
- `gguf_tpu_torch.compat` — the upstream reference's MMQ calling convention

Import boundary: this package imports `torch`, never `jax`, and nothing of
`gguf_tpu` — not even its modules that do not import jax. It keeps its
own copy of what it needs from them (GGUF I/O, `LlamaConfig`, the
quantizers and their C core).
"""

__version__ = "0.1.0"
