"""Fixed-shape hashing on the duplex sponge semantics.

Counterpart of ``sponge_tpu/hash.py:23-506``: batched 2-to-1 compression
(one permutation per node), fixed-length hashing of element blocks, the
Merkle root and tree with batched opening and verification, the same over
wide digests (d-element nodes, for small fields), and Jive-mode trees
(``sponge_tpu/hash.py:509-619``).  Every config of the port drives them.
The kernels take any batch width, so levels are neither chunked nor padded
(the JAX package pads to reuse XLA compilations).  A tree, each of its
levels, a batch of openings and a ``hash_elements`` call are spans
(``utils.profiling``: ``merkle.tree``, ``merkle.level``, ``merkle.open``,
``hash.elements``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import montgomery as mont
from .poseidon.permutation import SpongeConfig, absorb_permute, batched_permute
from .utils.profiling import ELEMENTS, LEVEL, OPEN, TREE, annotate


def hash_elements(
    cfg: SpongeConfig, elems: torch.Tensor, num_outputs: int = 1, backend: str = "auto"
) -> torch.Tensor:
    """(k, L, B) Montgomery element plane -> (num_outputs, L, B): fresh
    sponge, absorb k elements, squeeze ``num_outputs`` (Montgomery form).
    Each rate's chunk is one sponge step (``absorb_permute``), the last one
    the absorb -> squeeze flip, which keeps only the squeezed rows when they
    fit the rate."""
    k, _, B = elems.shape
    cap, rate = cfg.capacity, cfg.rate
    with annotate(ELEMENTS, B):
        state = None
        chunks = max(1, -(-k // rate))  # no elements: the flip alone
        for i in range(chunks):
            squeeze = i == chunks - 1 and num_outputs <= rate
            state = absorb_permute(cfg, state, 0, elems[i * rate : (i + 1) * rate],
                                   out_rows=(cap, cap + num_outputs) if squeeze else None, backend=backend)
        if num_outputs <= rate:
            return state
        outs = [state[cap : cap + rate]]
        remaining = num_outputs - rate
        while True:
            state = batched_permute(cfg, state, backend)
            if remaining <= rate:
                outs.append(state[cap : cap + remaining])
                return torch.cat(outs)
            outs.append(state[cap : cap + rate])
            remaining -= rate


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
    count = indices.numel() if isinstance(indices, torch.Tensor) else int(np.size(indices))
    with annotate(OPEN, count):
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
    elements and squeezes d (``hash_elements``).  When 2d <= rate that is one
    sponge step, which reads ``left`` and ``right`` where they lie (a
    level's even and odd lanes, with no copy)."""
    d = left.shape[0]
    if 2 * d > cfg.rate:
        return hash_elements(cfg, torch.cat([left, right]), num_outputs=d, backend=backend)
    with annotate(ELEMENTS, left.shape[-1]):
        return absorb_permute(cfg, None, 0, left, right, (cfg.capacity, cfg.capacity + d), backend)


def _tree_levels(cfg, leaves: torch.Tensor, backend: str, compress) -> list:
    """[(d, L, N), ..., (d, L, 1)]: each level compresses adjacent pairs of
    the one below with ``compress``; N a power of two."""
    d, L, N = leaves.shape
    if N < 1 or N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    levels = [leaves]
    with annotate(TREE, N):
        while levels[-1].shape[-1] > 1:
            half = levels[-1].shape[-1] // 2
            with annotate(LEVEL, half):
                pairs = levels[-1].reshape(d, L, half, 2)
                levels.append(compress(cfg, pairs[..., 0], pairs[..., 1], backend))
    return levels


def merkle_tree_wide(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> list:
    """All levels of a wide-digest tree, leaves first: [(d, L, N), ...,
    (d, L, 1)]; N a power of two."""
    return _tree_levels(cfg, leaves, backend, compress_digest_pairs)


def merkle_root_wide(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(d, L, N) digest plane -> (d, L) root."""
    return merkle_tree_wide(cfg, leaves, backend)[-1][..., 0]


# Authentication paths of K leaves of a wide tree, (depth, d, L, K): the
# same gather as the narrow one.
merkle_open_batch_wide = merkle_open_batch


def merkle_verify_batch_wide(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices,
    backend: str = "auto", compress=compress_digest_pairs,
) -> torch.Tensor:
    """Verify K wide-digest proofs: ``root`` (d, L), ``leaves`` (d, L, K),
    ``paths`` (depth, d, L, K) -> (K,) bool: K roots recomputed, one batched
    ``compress`` per level (``jive_compress_pairs`` for a Jive tree).  The
    port's planes are canonical, so equal limbs are equal values."""
    depth = paths.shape[0]
    idx = _indices(indices, 1 << depth, f"path depth {depth}", leaves.device)
    cur = leaves
    for d in range(depth):
        is_left = (idx & 1) == 0  # the lane is the left child
        left = torch.where(is_left, cur, paths[d])
        right = torch.where(is_left, paths[d], cur)
        cur = compress(cfg, left, right, backend)
        idx = idx >> 1
    return (cur == root[..., None]).reshape(-1, cur.shape[-1]).all(0)


# ---- Jive mode: the Anemoi paper's Merkle compression (ePrint 2022/840 §4) ----
#
# Jive_2 maps the whole t-element state to d = t/2 digest elements with one
# permutation and a feed-forward sum, with no capacity: a t = 2 permutation
# compresses two one-element digests.  Any even-width config drives it.


def jive_compress_pairs(
    cfg: SpongeConfig, left: torch.Tensor, right: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """(d, L, B) x (d, L, B) -> (d, L, B), d = t/2:
    ``digest_j = x_j + x_{d+j} + P(x)_j + P(x)_{d+j}`` with x = left ‖ right.
    The sum is reduced mod p, so the output is canonical (the JAX package's
    stays below 2p)."""
    d = left.shape[0]
    if cfg.t != 2 * d:
        raise ValueError(f"Jive_2 needs t = 2 * digest width; got t={cfg.t}, d={d}")
    fs = cfg.field
    x = torch.cat([left, right])
    px = batched_permute(cfg, x, backend)
    inputs = mont.mont_add(fs, x[:d], x[d:])
    outputs = mont.mont_add(fs, px[:d], px[d:])
    return mont.mont_add(fs, inputs, outputs).int()


def merkle_tree_jive(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> list:
    """All levels of a Jive-mode tree, leaves first: [(d, L, N), ...,
    (d, L, 1)], d = t/2, N a power of two.  Open proofs with
    ``merkle_open_batch_wide``; check them with ``merkle_verify_batch_jive``."""
    return _tree_levels(cfg, leaves, backend, jive_compress_pairs)


def merkle_root_jive(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(d, L, N) digest plane -> (d, L) Jive-mode root, one permutation per node."""
    return merkle_tree_jive(cfg, leaves, backend)[-1][..., 0]


def merkle_verify_batch_jive(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices,
    backend: str = "auto",
) -> torch.Tensor:
    """``merkle_verify_batch_wide`` with the Jive_2 compression: root (d, L),
    leaves (d, L, K), paths (depth, d, L, K) -> (K,) bool."""
    return merkle_verify_batch_wide(cfg, root, leaves, paths, indices, backend, jive_compress_pairs)
