"""The benchmark of the PyTorch and CUDA port (`gguf_tpu_torch`): the
harness, its configurations, traffic mixes and per-layer metric readers,
and the plain float32 reference that decides `correct`.
Entry point: `python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`."""
