"""The benchmark's entry point: one run of one cell, one process.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's checkpoint from the seed, opens `LLM` on the card,
warms up on the cell's shapes, measures a closed loop of `LLM.generate`
calls for `--seconds`, checks what the window served against the plain
float32 reference, and prints one JSON line last on standard output.
With `--trace 0` it reports the cell's end-to-end metrics, with
`--trace 1` its per-layer ones (`BENCHMARK.json`). Without a CUDA device,
or with fewer than the cell asks for, it exits with code 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def process_start() -> float:
    """This process's start on the `time.perf_counter` clock (Linux:
    /proc), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout; the
# port builds its kernels into gguf_tpu_torch/build/ itself
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import load_cell, print_result, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      T_START, log=lambda s: print(s, file=sys.stderr,
                                                   flush=True))
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
