"""One module per architecture: `perfbench/archs/<name>.py`, named by a
configuration file's `architecture` key (`perfbench.model.arch`). A
configuration of another architecture comes as new files: its module
here, its reference (`perfbench/references/<name>.py`), its
configuration file, and cells that use them.

A module provides, for a `perfbench.model.Model`:

- `tensor_plan(m)`: every tensor of the GGUF file in file order, as
  `perfbench.model.Tensor`s (name, format, shape, how an F32 tensor is
  made). `perfbench.weights` makes each from the seed and writes the
  file in this order.
- `metadata(m)`: the file's GGUF keys.
- The counts behind `perfbench.roofline`: `matmul_params(m)` (parameters
  of the matrix products one token uses, the head included),
  `head_params(m)`, `step_weight_bytes(m, live)` (bytes of the quantized
  matrices one decode step of `live` slots reads once),
  `attn_flops_per_row(m)` and `kv_row_bytes(m)`.
- `toy(m)`: the model at a size the CPU runs in seconds
  (`perfbench.checks.rehearse.toy`, `perfbench/tests`).
"""
