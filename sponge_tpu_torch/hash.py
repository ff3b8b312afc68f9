"""Fixed-shape hashing on the duplex sponge semantics.

Counterpart of ``sponge_tpu/hash.py:23-506``: batched 2-to-1 compression
(one permutation per node), fixed-length hashing of element blocks, the
Merkle root and tree with batched opening and verification, and the same
over wide digests (d-element nodes, for small fields).  Every config of the
port drives them.  The kernels take any batch width, so levels are neither
chunked nor padded (the JAX package pads to reuse XLA compilations).
"""

from __future__ import annotations

import torch

from .poseidon.permutation import SpongeConfig, batched_permute, zero_state
from .transcript import add_rows


def hash_elements(
    cfg: SpongeConfig, elems: torch.Tensor, num_outputs: int = 1, backend: str = "auto"
) -> torch.Tensor:
    """(k, L, B) Montgomery element plane -> (num_outputs, L, B): fresh
    sponge, absorb k elements, squeeze ``num_outputs`` (Montgomery form)."""
    k, _, B = elems.shape
    state = zero_state(cfg, B, elems.device)
    cap = cfg.capacity
    pos = 0
    while True:
        chunk = elems[pos : pos + cfg.rate]
        n = chunk.shape[0]
        if n:
            state = add_rows(cfg, state, 0, chunk)
        pos += n
        if pos >= k:
            break
        state = batched_permute(cfg, state, backend)
    state = batched_permute(cfg, state, backend)  # absorb -> squeeze flip
    outs = []
    remaining = num_outputs
    while True:
        if remaining <= cfg.rate:
            outs.append(state[cap : cap + remaining])
            break
        outs.append(state[cap : cap + cfg.rate])
        remaining -= cfg.rate
        state = batched_permute(cfg, state, backend)
    return torch.cat(outs)


def _pairwise(cfg: SpongeConfig) -> None:
    if cfg.rate < 2:
        raise ValueError("2-to-1 compression needs rate >= 2")


def compress_pairs(
    cfg: SpongeConfig, left: torch.Tensor, right: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """(L, B) x (L, B) Montgomery planes -> (L, B): the d = 1 case of
    ``compress_digest_pairs``.  A fresh sponge absorbs [l, r] and squeezes
    one native element; the one permutation is the absorb -> squeeze flip."""
    _pairwise(cfg)
    return compress_digest_pairs(cfg, left[None], right[None], backend)[0]


def merkle_tree(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> list:
    """All levels of the Merkle tree, leaves first: [(L, N), (L, N/2), ...,
    (L, 1)]; N a power of two.  level i+1[j] = compress(level i[2j],
    level i[2j+1]): the d = 1 case of ``merkle_tree_wide``."""
    _pairwise(cfg)
    return [level[0] for level in merkle_tree_wide(cfg, leaves[None], backend)]


def merkle_root(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(L, N) Montgomery leaf plane -> (L,) root."""
    return merkle_tree(cfg, leaves, backend)[-1][:, 0]


def merkle_open(levels: list, index: int) -> list:
    """Authentication path of leaf ``index``: the (L,) sibling columns,
    bottom-up."""
    n = levels[0].shape[-1]
    if not 0 <= index < n:
        raise IndexError(f"leaf index {index} out of range for {n} leaves")
    path = []
    for level in levels[:-1]:
        path.append(level[..., index ^ 1])
        index >>= 1
    return path


def _indices(indices, bound: int, what: str, device) -> torch.Tensor:
    idx = torch.as_tensor(indices, dtype=torch.int64, device=device).reshape(-1)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= bound):
        raise IndexError(f"leaf index out of range for {what}")
    return idx


def merkle_open_batch(levels: list, indices) -> torch.Tensor:
    """Authentication paths of K leaves as one (depth, ..., K) gather: path
    [d][..., k] is the sibling of leaf k's ancestor at depth d.  Serves the
    narrow (L, N) and the wide (d, L, N) levels alike."""
    idx = _indices(indices, levels[0].shape[-1], f"{levels[0].shape[-1]} leaves", levels[0].device)
    sibs = []
    for level in levels[:-1]:
        sibs.append(level.index_select(-1, idx ^ 1))
        idx = idx >> 1
    return torch.stack(sibs)


def merkle_verify_batch(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices,
    backend: str = "auto",
) -> torch.Tensor:
    """Verify K proofs: ``root`` (L,), ``leaves`` (L, K), ``paths`` (depth, L,
    K) from ``merkle_open_batch``, ``indices`` K ints -> (K,) bool (the
    d = 1 case of ``merkle_verify_batch_wide``)."""
    _pairwise(cfg)
    return merkle_verify_batch_wide(cfg, root[None], leaves[None], paths[:, None], indices, backend)


def merkle_verify(
    cfg: SpongeConfig, root: torch.Tensor, leaf: torch.Tensor, path: list, index: int, backend: str = "auto"
) -> bool:
    """Recompute the root from one (L,) leaf and its path and compare."""
    if not 0 <= index < (1 << len(path)):
        raise IndexError(f"leaf index {index} out of range for path depth {len(path)}")
    paths = torch.stack([s[:, None] for s in path])
    return bool(merkle_verify_batch(cfg, root, leaf[:, None], paths, [index], backend)[0])


# ---- wide digests: Merkle trees whose nodes are d-element digests ----
#
# Over a 255-bit field one element is a digest (d = 1, above).  Over a small
# field it is not collision-resistant (a 64-bit Goldilocks element gives
# 32-bit security), so a node is d = ceil(256 / bits) elements; with
# rate >= 2d a 2-to-1 compression is still one permutation.


def default_digest_elems(cfg: SpongeConfig) -> int:
    """Elements per Merkle digest for about 128-bit collision resistance:
    ceil(256 / field bits), 1 for the 255-bit fields, 4 for Goldilocks."""
    return max(1, -(-256 // cfg.field.modulus_bit_size))


def compress_digest_pairs(
    cfg: SpongeConfig, left: torch.Tensor, right: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """(d, L, B) x (d, L, B) -> (d, L, B): a fresh sponge absorbs the 2d
    elements and squeezes d (``hash_elements``; one permutation when
    2d <= rate)."""
    return hash_elements(cfg, torch.cat([left, right]), num_outputs=left.shape[0], backend=backend)


def merkle_tree_wide(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> list:
    """All levels of a wide-digest tree, leaves first: [(d, L, N), ...,
    (d, L, 1)]; N a power of two."""
    d, L, N = leaves.shape
    if N < 1 or N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    levels = [leaves]
    while levels[-1].shape[-1] > 1:
        pairs = levels[-1].reshape(d, L, levels[-1].shape[-1] // 2, 2)
        levels.append(compress_digest_pairs(cfg, pairs[..., 0], pairs[..., 1], backend))
    return levels


def merkle_root_wide(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(d, L, N) digest plane -> (d, L) root."""
    return merkle_tree_wide(cfg, leaves, backend)[-1][..., 0]


# Authentication paths of K leaves of a wide tree, (depth, d, L, K): the
# same gather as the narrow one.
merkle_open_batch_wide = merkle_open_batch


def merkle_verify_batch_wide(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices,
    backend: str = "auto",
) -> torch.Tensor:
    """Verify K wide-digest proofs: ``root`` (d, L), ``leaves`` (d, L, K),
    ``paths`` (depth, d, L, K) -> (K,) bool: K roots recomputed, one batched
    compression per level.  The port's planes are canonical, so equal limbs
    are equal values."""
    depth = paths.shape[0]
    idx = _indices(indices, 1 << depth, f"path depth {depth}", leaves.device)
    cur = leaves
    for d in range(depth):
        is_left = (idx & 1) == 0  # the lane is the left child
        left = torch.where(is_left, cur, paths[d])
        right = torch.where(is_left, paths[d], cur)
        cur = compress_digest_pairs(cfg, left, right, backend)
        idx = idx >> 1
    return (cur == root[..., None]).reshape(-1, cur.shape[-1]).all(0)
