"""Rehearse the whole harness on the CPU at a toy size of each cell's
configuration (its architecture's `toy`: for llama, 2 layers at small
widths, the same head ratio, tie and quantization recipe), a few
requests, the kernels' plain versions. Every step a chip run takes runs,
the trace and the reference included, down to the result line.
Run: python -m perfbench.checks.rehearse [cell ...]
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from perfbench.harness import load_cell, print_result, run_cell
from perfbench.model import arch


def toy(cell):
    """The cell at a size the CPU runs in seconds."""
    m = arch(cell.model).toy(cell.model)
    tr = dataclasses.replace(cell.traffic, requests_per_call=4,
                             prompt_tokens=(8, 40), max_new_tokens=24)
    return dataclasses.replace(cell, model=m, traffic=tr, check_requests=4)


def main(names) -> None:
    names = names or [w["name"] for w in
                      json.load(open("BENCHMARK.json"))["workloads"]]
    for name in names:
        for trace in (False, True):
            cell = toy(load_cell(name))
            print(f"== {name} (toy), trace {int(trace)}", file=sys.stderr)
            result = run_cell(cell, seed=2**31 + 12345, seconds=1.0,
                              trace=trace, t_start=time.perf_counter(),
                              device="cpu",
                              log=lambda s: print(s, file=sys.stderr))
            print_result(result)


if __name__ == "__main__":
    main(sys.argv[1:])
