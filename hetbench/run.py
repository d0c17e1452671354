"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 hetbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the port is imported from ./src. Exits
with a code other than 0, printing no result, without the CUDA cards the
cell asks for, or when JAX or the JAX package was loaded."""
import time

T_PROCESS = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from hetbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
