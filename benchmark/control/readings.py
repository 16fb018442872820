"""The readings a cell's ``correct`` limit is set from, on the card.

    python3 benchmark/control/readings.py --workload <cell> --seeds 11,12,13 --seconds 12

For each seed, in one process: one run of the cell at its own size and
load with a short window (the benchmark's own run, ``harness.main``);
then, on the same sample of served answers, the program's numbers and the
control's: the reference computed in fp8 (``reference/linear.py``) in the
program's place, judged by the same comparison and limits (the model
type's ``compare``, ``main.verdict``). One JSON line a seed, with each
side's ``correct``. The benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from harness import main  # noqa: E402


def readings(cell, seed, seconds, device="cuda"):
    """The program's verdict and the control's for one seed, each as
    ``{"correct": ..., "checks": ...}``."""
    box = {}

    def after(run, weights):
        box["control"] = run.model_type.compare(run, weights, control=True)

    run, _, checks = main.run_cell(cell, seed, seconds, False, time.monotonic_ns(),
                                   device=device, after=after)
    out = {}
    for side, numbers in (("program", checks), ("control", box["control"])):
        correct, numbers, _, _ = main.verdict(run, numbers)
        out[side] = {"correct": correct, "checks": numbers}
    return out


def run(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=12.0)
    args = parser.parse_args(argv)
    main.set_environment(BENCH.parent)
    cell = main.load_cell(BENCH.parent, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("the control's readings need the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = readings(cell, seed, args.seconds)
        for side, v in sides.items():
            for name, c in v["checks"].items():
                print(f"seed {seed} {side} {name}: {c['value']} (limit {c['limit']})",
                      file=sys.stderr)
            print(f"seed {seed} {side} correct: {v['correct']}", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, **sides}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
