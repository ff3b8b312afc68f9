"""Joining a process group, and the sharded permutation's scaling report.

Counterpart of ``sponge_tpu/parallel/multihost.py``.  One process per
device joins a ``torch.distributed`` group (NCCL for CUDA, gloo for the
CPU) and builds the global data mesh over every rank.  One process with no
launcher forms a group of world size 1, so the same sharded code runs
everywhere.

Launch one process per GPU with torchrun:

    torchrun --standalone --nproc-per-node=N -m sponge_tpu_torch.parallel.multihost

or programmatically::

    from sponge_tpu_torch.parallel.multihost import initialize, global_mesh
    initialize()            # torchrun's environment, else world size 1
    mesh = global_mesh()    # all ranks, 1-D "data"
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import sharded
from .mesh import local_device, local_range, make_mesh, process_group_backend


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Join the default process group: NCCL for "cuda", gloo for "cpu".

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with no such
    environment it forms a one-process group on a local store.  A CUDA
    rank drives ``cuda:LOCAL_RANK`` (default: rank modulo the visible GPUs).
    """
    backend = process_group_backend(device_type)
    if dist.is_initialized():
        raise RuntimeError("this process has already joined a process group")
    if init_method is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
    if init_method is None:
        kwargs = dict(store=dist.HashStore(), world_size=1, rank=0)
    else:  # env:// reads the rank and world size it is not given
        kwargs = dict(init_method=init_method)
        kwargs.update({k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None})
    if device_type == "cuda":
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, **kwargs)


def global_mesh() -> DeviceMesh:
    """1-D data mesh over every rank of the group, on the device type that
    the group's backend serves."""
    return make_mesh(device_type="cuda" if dist.get_backend() == "nccl" else "cpu")


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def scaling_report(
    cfg,
    batch_per_device: int = 1 << 17,
    reps: int = 5,
    parity_lanes: int = 64,
    parity_stride: int = 7,
) -> dict:
    """Sharded permutation throughput on the global mesh:
    {devices, perms_per_sec, perms_per_sec_per_device}.

    Parity-gated: the lanes hold ``parity_lanes`` random states tiled
    periodically across the batch, so every rank's slice holds known lanes,
    and the first permutation of each rank's slice is checked against the
    scalar oracle before any time is taken.  A mismatch on any rank raises
    ``RuntimeError`` on every rank, with no number.  Timing: one untimed
    window of ``reps`` permutations, then the best of 3 timed windows,
    completion forced by a device synchronize.
    """
    fs = cfg.field
    mesh = global_mesh()
    D = mesh.size()
    B = batch_per_device * D
    lanes = local_range(mesh, B)
    parity_lanes = min(parity_lanes, batch_per_device)
    dev = local_device(mesh)

    rng = np.random.default_rng(1234)
    vals = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=parity_lanes)]
        for _ in range(cfg.t)
    ]
    seed_plane = np.stack([fs.ints_to_mont_plane(row) for row in vals])  # (t, L, parity_lanes)
    cols = np.arange(lanes.start, lanes.stop) % parity_lanes
    state = torch.from_numpy(np.ascontiguousarray(seed_plane[..., cols])).to(dev)
    fn = sharded.sharded_permute_fn(cfg, mesh)
    out = fn(state)

    oracle = []
    for b in range(parity_lanes):
        o = cfg.oracle_sponge()
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        oracle.append([v % fs.modulus for v in o.state])
    local = out.cpu().numpy()
    bad = None
    for k in range(0, min(parity_lanes, local.shape[-1]), parity_stride):
        got = [fs.mont_plane_to_ints(local[i][:, k : k + 1])[0] for i in range(cfg.t)]
        if got != oracle[(lanes.start + k) % parity_lanes]:
            bad = k
            break
    ok = torch.tensor([int(bad is None)], device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.get_group())
    if bad is not None:
        raise RuntimeError(
            f"scaling_report PARITY FAILURE at local lane {bad} (global {lanes.start + bad}); "
            "refusing to report a throughput number"
        )
    if not int(ok.item()):
        raise RuntimeError(
            "scaling_report PARITY FAILURE on another rank; refusing to report a throughput number"
        )

    for _ in range(reps):
        out = fn(out)
    _sync(out)
    best_dt = None
    for _w in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(out)
        _sync(out)
        dt = (time.perf_counter() - t0) / reps
        best_dt = dt if best_dt is None else min(best_dt, dt)
    return {
        "devices": D,
        "perms_per_sec": B / best_dt,
        "perms_per_sec_per_device": B / best_dt / D,
    }


def _main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch-per-device", type=int, default=1 << 17)
    parser.add_argument("--device-type", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()

    from ..fields import BLS12_381_FR
    from ..poseidon.params import get_default_poseidon_parameters

    initialize(device_type=args.device_type)
    try:
        cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
        report = scaling_report(cfg, args.batch_per_device)
        if dist.get_rank() == 0:
            print(json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
