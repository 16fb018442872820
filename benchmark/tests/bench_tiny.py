"""Tiny versions of the benchmark's cells, for runs on the CPU: the
cells' own files cut down by their model type's ``tiny`` (widths, depth,
vocabulary, traffic, and the limits of the check) and run in float32
arithmetic, so that a run takes seconds. The program then computes what
the float32 reference does, so the tiny cells hold it to limits near
nought, between its readings and the fp8 control's at these sizes (each
model type's ``tiny`` gives them)."""

import time
from pathlib import Path

from harness import main, systems

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 1234


def cell(name: str):
    cell = main.load_cell(ROOT, name)
    config = cell["config_doc"]
    systems.load(config["serve"]["system"]).tiny(config, cell["mix"])
    config["serve"]["dtype"] = "float32"
    return cell


def run(name: str, seconds: float = 3.0, trace: bool = False, seed: int = SEED):
    """One run of the tiny cell on the CPU: (run, its result line)."""
    run, _, checks = main.run_cell(cell(name), seed, seconds, trace, time.monotonic_ns(),
                                   device="cpu")
    return run, main.result_line(run, checks)
