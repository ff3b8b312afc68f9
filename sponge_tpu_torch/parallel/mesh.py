"""The 1-D data mesh over a ``torch.distributed`` process group.

Counterpart of ``sponge_tpu/parallel/mesh.py``.  The parallel axis of a
sponge workload is the batch of independent lanes.  One process drives one
device, and rank r of D holds the contiguous chunk ``r*B/D ... (r+1)*B/D``
of the lane axis of every plane, as a plain tensor: the kernels are ctypes
launches and never see a DTensor.  The sharding names return the DTensor
placements that describe that layout.

A CUDA mesh runs on an NCCL group, a CPU mesh on a gloo group; nothing picks
one for the other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def process_group_backend(device_type: str) -> str:
    """The collective backend of a device type: NCCL for "cuda", gloo for
    "cpu".  A CUDA mesh with no GPU raises."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device_type='cpu' for a gloo group on the CPU")
    return _BACKEND[device_type]


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named ("data",) over the ranks of the default process group
    (``multihost.initialize``).  A mesh spans every rank, one device each,
    so ``n_devices``, if given, must be the group's size."""
    backend = process_group_backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call sponge_tpu_torch.parallel.multihost.initialize first")
    if dist.get_backend() != backend:
        raise ValueError(f"a {device_type} mesh needs a {backend} group; this one is {dist.get_backend()}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans every rank: n_devices must be {world}, not {n_devices}")
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(DATA_AXIS,))


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_range(mesh: DeviceMesh, n: int) -> range:
    """This rank's contiguous chunk of ``n`` lanes; n divisible by the mesh
    size."""
    D = mesh.size()
    if n % D:
        raise ValueError(f"{n} lanes are not divisible by the mesh size {D}")
    r = mesh.get_local_rank()
    return range(r * n // D, (r + 1) * n // D)


def check_local(mesh: DeviceMesh, *planes: torch.Tensor) -> None:
    """A rank's slices live on the mesh's device type."""
    for plane in planes:
        if plane.device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh got a plane on {plane.device}")


def batch_sharding(mesh: DeviceMesh) -> list:
    """(t, L, B) / (k, L, B) / (d, L, N) planes: the lane axis over the mesh."""
    return [Shard(2)]


def leaf_sharding(mesh: DeviceMesh) -> list:
    """(L, N) leaf planes: the leaf axis over the mesh."""
    return [Shard(1)]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()]
