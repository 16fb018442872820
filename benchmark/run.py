"""Run one cell of the port's benchmark on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard
output (see ``harness/main.py`` and ``README.md``); exits non-zero,
printing no result, without the card the cell asks for.
"""

import time

T0_NS = time.monotonic_ns()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0_NS))
