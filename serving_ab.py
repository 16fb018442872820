"""A/B of ``chip_smoke.py``'s serving phases between two trees on one card.

    git archive <commit> | tar -x -C build/parent
    python3 serving_ab.py --against build/parent

Runs phases 6b (BERT-large), 7b with 8b (ResNet-50 from client threads,
then from client processes), 7c and 8c (the data plane from threads, then
from processes) of each tree's own ``chip_smoke.py``, in the order other,
this, this, other, each run a process of its own started in the tree it
measures. Prints the runs' ``kserve:``, ``image:``, ``image-procs:``,
``data plane:`` and ``data-plane-procs:`` lines, each run under a
``=== <tree>`` line; exits non-zero if a run fails.
"""

import argparse
import os
import subprocess
import sys

LINES = ("kserve: {", "image: {", "image-procs: ", "data plane: ", "data-plane-procs: ")


def run_phases(tree: str) -> None:
    """The serving phases of ``tree``'s ``chip_smoke.py``, in this process."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.kserve_bert_large()
    chip_smoke.classifier_resnet50()
    chip_smoke.data_plane()
    chip_smoke.data_plane_procs()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", required=True, help="the other tree's directory")
    parser.add_argument("--run", help=argparse.SUPPRESS)  # one run, in a child
    args = parser.parse_args()
    if args.run:
        run_phases(args.run)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.against)
    for tree in (other, here, here, other):
        print(f"=== {tree}", flush=True)
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--against", other,
                               "--run", tree], cwd=tree, capture_output=True, text=True)
        for line in done.stdout.splitlines():
            if line.startswith(LINES):
                print(line, flush=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr, flush=True)
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
