"""Run one cell of the benchmark of sponge_tpu_torch on this machine's cards.

    python3 spongebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the check lines last on standard error and one JSON result as the
last line of standard output.  Exits non-zero, printing no result, without
the CUDA devices the cell asks for.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from spongebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
