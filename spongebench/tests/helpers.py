"""Tiny runs of the real cells on the CPU, through the plain tier."""

import time

from spongebench import harness


def tiny_cell(name: str, leaves_log2: int = 2):
    cell = harness.resolve(name)
    cell.traffic = dict(cell.traffic, leaves_log2=leaves_log2)
    return cell


def tiny_run(name: str, seed: int = 2**31 + 7, control=False, leaves_log2: int = 2, trace=False):
    return harness.run(tiny_cell(name, leaves_log2), seed, 0, trace, "cpu", time.perf_counter(), control)
