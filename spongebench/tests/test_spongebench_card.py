"""On a card: one short run of each cell is correct and its control is
not.  These skip without a CUDA device."""

import json
import subprocess
import sys

import pytest

from spongebench.harness import ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def _run(script, name, seed):
    proc = subprocess.run([sys.executable, f"spongebench/{script}", "--workload", name, "--seed", str(seed),
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(cuda, name):
    assert _run("run.py", name, 2**31 + 11)["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(cuda, name):
    assert _run("control.py", name, 2**31 + 13)["correct"] is False
