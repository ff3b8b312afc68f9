"""Sharded batched permutation and transcript.

Counterpart of ``sponge_tpu/parallel/sharded.py``.  Lanes are independent
sponges, so each rank advances its local slice of the batch with no
communication: each function here is a closure over the mesh that runs
``batched_permute`` or ``transcript._replay`` on the slice it is given.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..poseidon.permutation import SpongeConfig, batched_permute, zero_state
from ..transcript import _replay, transcript_shape
from .mesh import check_local, local_device, local_range


def sharded_permute_fn(cfg: SpongeConfig, mesh: DeviceMesh, backend: str = "auto"):
    """``fn(local)``: this rank's (t, L, B/D) slice -> its permuted slice."""

    def run(local: torch.Tensor) -> torch.Tensor:
        check_local(mesh, local)
        return batched_permute(cfg, local, backend)

    return run


def sharded_state(cfg: SpongeConfig, mesh: DeviceMesh, batch: int) -> torch.Tensor:
    """This rank's zero (t, L, batch/D) slice of a ``batch``-lane state;
    ``batch`` divisible by the mesh size."""
    return zero_state(cfg, len(local_range(mesh, batch)), local_device(mesh))


def sharded_transcript_fn(cfg: SpongeConfig, steps, mesh: DeviceMesh, backend: str = "auto"):
    """``fn(elems)``: this rank's (total_absorbed, L, B/D) Montgomery slice
    -> its (total_squeezed, L, B/D) canonical output, as
    ``compile_transcript``."""
    steps = tuple(steps)
    total_absorbed, _ = transcript_shape(steps)

    def run(elems: torch.Tensor) -> torch.Tensor:
        check_local(mesh, elems)
        if elems.shape[0] != total_absorbed:
            raise ValueError(
                f"transcript input plane has {elems.shape[0]} element rows; "
                f"the schedule absorbs {total_absorbed}"
            )
        return _replay(cfg, steps, elems, backend)

    return run
