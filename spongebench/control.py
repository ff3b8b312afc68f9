"""The control of ``correct``: a run of a cell with its family's control
config in the program's place (for Poseidon, R_P - 1: the last partial
round and its constants dropped), the cut that would tempt a faster hash.
The judge still holds the outputs to the configuration's reference, so
``correct`` has to come out false.  Run it as the benchmark is run:

    python3 spongebench/control.py --workload <cell> --seed <n> --seconds <s> --trace 0
"""

import pathlib
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from spongebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, control=True))
