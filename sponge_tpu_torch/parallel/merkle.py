"""Sharded Merkle trees over the data mesh.

Counterpart of ``sponge_tpu/parallel/merkle.py``: the ``BASELINE.json``
workload, a 2-to-1 Merkle tree over 2^24 leaves, layer by layer.

* Rank r holds the contiguous chunk r of the leaves, so while a level is
  wide every pair is local: each rank reduces its chunk level by level with
  no communication, down to its one subtree root.
* The narrow tail: one ``all_gather_into_tensor`` of the D subtree roots,
  then every rank finishes the D-node tree itself (O(D) work).

The JAX package pads the wide levels to reuse XLA compilations; the kernels
here take any width, so nothing is padded.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..hash import (
    _pairwise,
    _tree_levels,
    compress_digest_pairs,
    jive_compress_pairs,
    merkle_verify_batch,
)
from ..poseidon.permutation import SpongeConfig
from .mesh import check_local


def _check_chunks(mesh: DeviceMesh, n_local: int, device) -> None:
    """Every rank holds a chunk of the same size and the whole tree has a
    power-of-two leaf count.  The sizes are gathered, so every rank raises
    together rather than leave the others waiting in the gather."""
    D = mesh.size()
    sizes = torch.empty(D, dtype=torch.int64, device=device)
    mine = torch.tensor([n_local], dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(sizes, mine, group=mesh.get_group())
    sizes = sizes.tolist()
    if len(set(sizes)) != 1:
        raise ValueError(f"leaf count must be divisible by the mesh size: the ranks hold {sizes} leaves")
    n = n_local * D
    if n < 1 or n & (n - 1):
        raise ValueError("leaf count must be a power of two")


def sharded_merkle_root_wide(
    cfg: SpongeConfig,
    leaves: torch.Tensor,
    mesh: DeviceMesh,
    backend: str = "auto",
    compress=compress_digest_pairs,
) -> torch.Tensor:
    """This rank's (d, L, N/D) chunk of a (d, L, N) digest plane -> the
    (d, L) root, the same on every rank.  ``compress`` is the per-node
    compression (sponge mode by default; ``sharded_merkle_root_jive``
    passes Jive_2)."""
    check_local(mesh, leaves)
    d, L, n_local = leaves.shape
    _check_chunks(mesh, n_local, leaves.device)
    level = leaves
    while level.shape[-1] > 1:  # the wide phase: local pairs only
        pairs = level.reshape(d, L, level.shape[-1] // 2, 2)
        level = compress(cfg, pairs[..., 0], pairs[..., 1], backend)
    send = level[..., 0].contiguous()[None]  # (1, d, L)
    nodes = torch.empty((mesh.size(),) + send.shape[1:], dtype=send.dtype, device=send.device)
    dist.all_gather_into_tensor(nodes, send, group=mesh.get_group())
    return _tree_levels(cfg, nodes.permute(1, 2, 0).contiguous(), backend, compress)[-1][..., 0]


def sharded_merkle_root(
    cfg: SpongeConfig, leaves: torch.Tensor, mesh: DeviceMesh, backend: str = "auto"
) -> torch.Tensor:
    """This rank's (L, N/D) chunk of an (L, N) leaf plane -> the (L,) root
    (the d = 1 case of ``sharded_merkle_root_wide``)."""
    _pairwise(cfg)
    return sharded_merkle_root_wide(cfg, leaves[None], mesh, backend)[0]


def sharded_merkle_root_jive(
    cfg: SpongeConfig, leaves: torch.Tensor, mesh: DeviceMesh, backend: str = "auto"
) -> torch.Tensor:
    """Jive-mode sharded root: (d, L, N/D) chunk, d = t/2 -> (d, L) root
    (see ``hash.merkle_root_jive``)."""
    return sharded_merkle_root_wide(cfg, leaves, mesh, backend, compress=jive_compress_pairs)


def sharded_merkle_verify_batch(
    cfg: SpongeConfig,
    root: torch.Tensor,
    leaves: torch.Tensor,
    paths: torch.Tensor,
    indices,
    mesh: DeviceMesh,
    backend: str = "auto",
) -> torch.Tensor:
    """``hash.merkle_verify_batch`` on this rank's slice of K proofs: root
    (L,) on every rank, leaves (L, K/D), paths (depth, L, K/D), indices
    (K/D,) -> (K/D,) bool.  Proofs are independent: no communication."""
    check_local(mesh, root, leaves, paths)
    return merkle_verify_batch(cfg, root, leaves, paths, indices, backend)
