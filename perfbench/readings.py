"""The readings a cell's correctness limit is set from, at the cell's own
size on the chip: the program's widest gap (served token below the f32
reference's best logit) on a dozen seeds or more, and the control's on
three or more.

Two controls, since the served precision is bf16 and the next one below
is int8 or fp8. The program's own int8 path, `MMOpts(act_quant=True)`
(llama.cpp's Q8_1 activations), runs as the program in the
`--act-quant-seeds` runs. The reference in float8 e4m3 activations
(`references.<arch>.control_gaps`) is read in every run beside the
program's own gap: at each position of the same prompts and served
tokens, the gap of the token the fp8 reference puts first.

Each seed is one short run in this process: the cell's checkpoint, the
warm-up call and one call of the cell's load (so the sample is drawn as
a run draws it), then the reference. The benchmark's own runs never run
a control.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--act-quant-seeds 4,5,6]

Prints one JSON line per seed: {"seed", "act_quant", "program_max_gap",
"program_mean_gap", "fp8_control_max_gap", "fp8_control_mean_gap",
"correct", "control_correct", "control_check", ...}: `control_correct` is
the fp8 control's gaps put through the harness's own comparison under
the cell's committed limits, and has to read false.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--act-quant-seeds", default="")
    args = p.parse_args(argv)

    import torch

    from gguf_tpu_torch.models.llama import MMOpts
    from perfbench.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.act_quant_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        result = run_cell(cell, seed, 0.0, False, t0,
                          opts=MMOpts(act_quant=control), control=True,
                          log=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps({
            "workload": cell.name, "seed": seed, "act_quant": control,
            **{f"program_{k}": v for k, v in result["gaps"].items()},
            **{f"fp8_control_{k}": v
               for k, v in result["control_gaps"].items()},
            "correct": result["correct"],
            "control_correct": result["control_correct"],
            "control_check": result["control_check"],
            "failed": result["failed"],
            "nonfinite_calls": result["check"]["nonfinite_calls"]["value"],
            "seconds": time.perf_counter() - t0,
            "memory_allocated_after": torch.cuda.memory_allocated()}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
