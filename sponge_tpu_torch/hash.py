"""Fixed-shape hashing on the duplex sponge semantics.

Counterpart of ``sponge_tpu/hash.py:23-506``: batched 2-to-1 compression
(one permutation per node), fixed-length hashing of element blocks, the
Merkle root and tree with batched opening and verification, the same over
wide digests (d-element nodes, for small fields), Jive-mode trees
(``sponge_tpu/hash.py:509-619``), Plonky3's padding-free sponge and
truncated-permutation trees, Miden's length-tagged overwrite sponge
(``rpo_hash_elements``), and arity-k trees whose node hash starts from a
domain tag in the capacity (Filecoin's, over neptune's Poseidon:
``merkle_tree_arity``).  Every config of the port drives them.
The kernels take any batch width, so levels are neither chunked nor padded
(the JAX package pads to reuse XLA compilations).  A tree, each of its
levels, a batch of openings, a ``hash_elements``, a ``padding_free_hash``
and an ``rpo_hash_elements`` call and each truncated or tagged compression
are spans (``utils.profiling``: ``merkle.tree``, ``merkle.level``,
``merkle.open``, ``hash.elements``, ``hash.padding_free``, ``hash.rpo``,
``merkle.truncate``, ``merkle.tagged``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import montgomery as mont
from .poseidon.permutation import (
    SpongeConfig,
    absorb_permute,
    batched_permute,
    overwrite_permute,
    overwrite_rows,
    zero_state,
)
from .utils.profiling import ELEMENTS, LEVEL, OPEN, PADDING_FREE, RPO, TAGGED, TREE, TRUNCATE, annotate


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
    """K leaf indices as an int64 tensor on ``device``, each in [0, bound).
    Indices given on the host are checked there and reach a CUDA device by
    a pinned, non-blocking copy, so neither waits for the device's queue:
    the gathers that use them queue behind the tree the device is still
    computing."""
    if isinstance(indices, torch.Tensor):
        idx = indices.to(device=device, dtype=torch.int64).reshape(-1)
        lo, hi = (int(idx.min()), int(idx.max())) if idx.numel() else (0, 0)
    else:
        host = np.asarray(indices, dtype=np.int64).reshape(-1)
        lo, hi = (int(host.min()), int(host.max())) if host.size else (0, 0)
        idx = torch.from_numpy(host)
        if torch.device(device).type == "cuda":
            idx = idx.pin_memory().to(device, non_blocking=True)
        else:
            idx = idx.to(device)
    if lo < 0 or hi >= bound:
        raise IndexError(f"leaf index out of range for {what}")
    return idx


def merkle_open_batch(levels: list, indices) -> torch.Tensor:
    """Authentication paths of K leaves as one (depth, ..., K) gather: path
    [d][..., k] is the sibling of leaf k's ancestor at depth d, whose index
    is (k >> d) ^ 1.  Serves the narrow (L, N) and the wide (d, L, N)
    levels alike."""
    count = indices.numel() if isinstance(indices, torch.Tensor) else int(np.size(indices))
    with annotate(OPEN, count):
        idx = _indices(indices, levels[0].shape[-1], f"{levels[0].shape[-1]} leaves", levels[0].device)
        sib = (idx >> torch.arange(len(levels) - 1, device=idx.device)[:, None]) ^ 1
        return torch.stack([level.index_select(-1, sib[d]) for d, level in enumerate(levels[:-1])])


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


# ---- Plonky3's modes: the padding-free sponge and the truncated permutation ----
#
# Plonky3 (and SP1, which commits with it) puts the rate in front of the
# capacity.  ``PaddingFreeSponge`` hashes a row by overwriting the rate with
# each chunk and permuting, with no padding; ``TruncatedPermutation``
# compresses two d-element digests by permuting left ‖ right and keeping the
# first d elements: one permutation per node, with no capacity and no
# feed-forward (t = 2d).  Any config drives them.


def padding_free_hash(
    cfg: SpongeConfig, elems: torch.Tensor, num_outputs: int, backend: str = "auto"
) -> torch.Tensor:
    """(k, L, B) Montgomery element plane -> (num_outputs, L, B), Plonky3's
    ``PaddingFreeSponge``: a zero state; for each chunk of up to ``rate``
    elements, rows [0, len(chunk)) overwritten and the state permuted, so a
    k that is a multiple of the rate takes no further permutation; then
    rows [0, num_outputs) of the state, num_outputs <= rate.  One launch
    for all chunks where the config's module has the overwrite sponge
    (``overwrite_permute``), else ``overwrite_rows`` and a permutation a
    chunk."""
    k, _, B = elems.shape
    if not 0 < num_outputs <= cfg.rate:
        raise ValueError(f"num_outputs must be in [1, rate={cfg.rate}]; got {num_outputs}")
    with annotate(PADDING_FREE, B):
        fused = overwrite_permute(cfg, (elems,), cfg.rate, num_outputs, backend)
        if fused is not None:
            return fused
        state = zero_state(cfg, B, elems.device)
        for lo in range(0, k, cfg.rate):
            state = batched_permute(cfg, overwrite_rows(cfg, state, elems[lo : lo + cfg.rate]), backend)
        return state[:num_outputs].clone()


def truncated_compress_pairs(
    cfg: SpongeConfig, left: torch.Tensor, right: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """(d, L, B) x (d, L, B) -> (d, L, B), t = 2d, Plonky3's
    ``TruncatedPermutation``: the first d rows of the permuted left ‖ right.
    Where the config's module has the overwrite sponge, one chunk of t rows
    read from ``left`` and ``right`` where they lie (a level's even and odd
    lanes, with no copy); else their ``cat``, the permutation and a copy
    of the rows kept."""
    d = left.shape[0]
    if cfg.t != 2 * d:
        raise ValueError(f"a truncated permutation needs t = 2 * digest width; got t={cfg.t}, d={d}")
    with annotate(TRUNCATE, left.shape[-1]):
        fused = overwrite_permute(cfg, (left, right), cfg.t, d, backend)
        if fused is not None:
            return fused
        return batched_permute(cfg, torch.cat([left, right]), backend)[:d].clone()


def merkle_tree_truncated(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> list:
    """All levels of a truncated-permutation tree, leaves first: [(d, L, N),
    ..., (d, L, 1)], d = t/2, N a power of two.  Open proofs with
    ``merkle_open_batch_wide``; check them with
    ``merkle_verify_batch_truncated``."""
    return _tree_levels(cfg, leaves, backend, truncated_compress_pairs)


def merkle_root_truncated(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(d, L, N) digest plane -> (d, L) root, one permutation per node."""
    return merkle_tree_truncated(cfg, leaves, backend)[-1][..., 0]


def merkle_verify_batch_truncated(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices,
    backend: str = "auto",
) -> torch.Tensor:
    """``merkle_verify_batch_wide`` with the truncated permutation: root
    (d, L), leaves (d, L, K), paths (depth, d, L, K) -> (K,) bool."""
    return merkle_verify_batch_wide(cfg, root, leaves, paths, indices, backend, truncated_compress_pairs)


# ---- Miden's mode: the length-tagged overwrite sponge ----
#
# Miden (miden-crypto ``Rpo256::hash_elements``) puts the capacity in front
# and tags the input's length in it: capacity element 0 starts as k mod rate.
# Each chunk of ``rate`` elements overwrites the rate, a last partial chunk
# padded with zeros, and the state is permuted; the digest is the rate's
# first rows.  ``Rpo256::merge`` writes two digests over the rate of a zero
# state with no tag and permutes once: ``compress_digest_pairs`` (adding
# into a zero rate is writing over it), so ``merkle_tree_wide`` is Miden's
# tree.


def rpo_initial_state(cfg: SpongeConfig, k: int, batch: int, device) -> torch.Tensor:
    """Miden's sponge state before k elements: zero, with capacity row 0 =
    k mod rate (Montgomery form), each limb a fill of the fresh plane (no
    copy from the host)."""
    fs = cfg.field
    state = zero_state(cfg, batch, device)
    for limb, v in enumerate(fs.int_to_limbs(fs.to_mont(k % cfg.rate)).tolist()):
        state[0, limb] = v
    return state


def rpo_hash_elements(
    cfg: SpongeConfig, elems: torch.Tensor, num_outputs: int, backend: str = "auto"
) -> torch.Tensor:
    """(k, L, B) Montgomery element plane -> (num_outputs, L, B), Miden's
    ``hash_elements`` over any config whose capacity comes first: from
    ``rpo_initial_state``, for each chunk of ``rate`` elements, the last
    zero-padded, rows [capacity, t) overwritten (``overwrite_rows``) and
    the state permuted, so a k that is a multiple of the rate takes no
    further permutation; then rows [capacity, capacity + num_outputs),
    num_outputs <= rate."""
    k, L, B = elems.shape
    cap, rate = cfg.capacity, cfg.rate
    if not 0 < num_outputs <= rate:
        raise ValueError(f"num_outputs must be in [1, rate={rate}]; got {num_outputs}")
    with annotate(RPO, B):
        state = rpo_initial_state(cfg, k, B, elems.device)
        for lo in range(0, k, rate):
            chunk = elems[lo : lo + rate]
            if chunk.shape[0] < rate:
                chunk = torch.cat([chunk, chunk.new_zeros((rate - chunk.shape[0], L, B))])
            state = batched_permute(cfg, overwrite_rows(cfg, state, chunk, cap), backend)
        return state[cap : cap + num_outputs].clone()


# ---- arity-k trees with a domain-tagged node hash: Filecoin's ----
#
# Filecoin's sealing trees (rust-fil-proofs ``PoseidonHasher`` over
# neptune's Poseidon) hash k children into their parent with one
# permutation at t = k + 1: the state is [tag, c_0, ..., c_{k-1}], the tag
# in the capacity, and the parent is element 1.  Neptune's tag for a Merkle
# tree of arity k is 2^k - 1 (``HashType::MerkleTree``).  Adding the
# children into a fresh state's rate is writing them there, so the node
# hash is one sponge step that starts from the tag (``absorb_permute``'s
# ``tag``), kept rows (capacity, capacity + 1).


def neptune_merkle_tag(arity: int) -> int:
    """Neptune's domain tag of an arity-k Merkle tree's node hash
    (``HashType::MerkleTree``): 2^arity - 1, 255 at arity 8."""
    if arity < 2:
        raise ValueError(f"a tree's arity is at least 2; got {arity}")
    return (1 << arity) - 1


def compress_children(cfg: SpongeConfig, children: torch.Tensor, tag=None, backend: str = "auto") -> torch.Tensor:
    """(k, L, B) view of any strides -> (L, B), 2 <= k <= rate: for each
    lane a fresh sponge whose capacity element 0 is ``tag`` (the rest of the
    capacity zero; all of it zero for None) absorbs the k children and gives
    state row ``capacity``.  One sponge step (``absorb_permute``; on kernel
    1 the tag folded into the first round's constants), which reads the
    children where they lie.  A ``merkle.tagged`` span, its count the
    nodes."""
    k, _, B = children.shape
    if not 2 <= k <= cfg.rate:
        raise ValueError(f"a node hashes 2 to rate = {cfg.rate} children; got {k}")
    cap = None if tag is None else (tag,) + (0,) * (cfg.capacity - 1)
    with annotate(TAGGED, B):
        return absorb_permute(cfg, None, 0, children, None, (cfg.capacity, cfg.capacity + 1), backend, cap)[0]


def _arity_depth(n: int, arity: int) -> int:
    """Levels above n leaves of an arity-k tree; n must be a power of k."""
    if arity < 2:
        raise ValueError(f"a tree's arity is at least 2; got {arity}")
    depth, m = 0, n
    while m > 1 and m % arity == 0:
        m, depth = m // arity, depth + 1
    if n < 1 or m != 1:
        raise ValueError(f"leaf count must be a power of the arity {arity}; got {n}")
    return depth


def merkle_tree_arity(cfg: SpongeConfig, leaves: torch.Tensor, arity: int, tag=None,
                      backend: str = "auto") -> list:
    """All levels of an arity-k tree, leaves first: [(L, N), (L, N/k), ...,
    (L, 1)], N a power of k.  level i+1[j] = compress_children(level
    i[kj .. kj + k - 1], tag); each level is one call over the (k, L, N/k)
    view of the level below (``reshape(L, N/k, k).permute(2, 0, 1)``, lane
    stride k), with no copy.  Spans ``merkle.tree`` (the leaves) and
    ``merkle.level`` (the nodes) around each ``merkle.tagged``."""
    L, n = leaves.shape
    depth = _arity_depth(n, arity)
    levels = [leaves]
    with annotate(TREE, n):
        for _ in range(depth):
            m = levels[-1].shape[-1] // arity
            with annotate(LEVEL, m):
                children = levels[-1].reshape(L, m, arity).permute(2, 0, 1)
                levels.append(compress_children(cfg, children, tag, backend))
    return levels


def merkle_root_arity(cfg: SpongeConfig, leaves: torch.Tensor, arity: int, tag=None,
                      backend: str = "auto") -> torch.Tensor:
    """(L, N) Montgomery leaf plane -> (L,) root of the arity-k tree."""
    return merkle_tree_arity(cfg, leaves, arity, tag, backend)[-1][:, 0]


def merkle_open_batch_arity(levels: list, indices, arity: int) -> torch.Tensor:
    """Authentication paths of K leaves of an arity-k tree as one
    (depth, k - 1, L, K) gather: path [d][j][:, i] is the j-th of the k - 1
    siblings, in their order, of leaf i's ancestor a at depth d
    (a = index // k^d), the node itself left out."""
    L, n = levels[0].shape
    count = indices.numel() if isinstance(indices, torch.Tensor) else int(np.size(indices))
    with annotate(OPEN, count):
        idx = _indices(indices, n, f"{n} leaves", levels[0].device)
        K = idx.shape[0]
        j = torch.arange(arity - 1, device=idx.device)[:, None]
        paths = []
        for level in levels[:-1]:
            slot = idx % arity
            sib = idx - slot + j + (j >= slot).long()  # (k - 1, K)
            paths.append(level.index_select(-1, sib.reshape(-1)).reshape(L, arity - 1, K).transpose(0, 1))
            idx = idx // arity
        if not paths:
            return levels[0].new_empty((0, arity - 1, L, K))
        return torch.stack(paths)


def merkle_verify_batch_arity(
    cfg: SpongeConfig, root: torch.Tensor, leaves: torch.Tensor, paths: torch.Tensor, indices, arity: int,
    tag=None, backend: str = "auto",
) -> torch.Tensor:
    """Verify K proofs of an arity-k tree: ``root`` (L,), ``leaves`` (L, K),
    ``paths`` (depth, k - 1, L, K) from ``merkle_open_batch_arity``,
    ``indices`` K ints -> (K,) bool: K roots recomputed, each level one
    ``compress_children`` over the lane's node put back among its
    siblings at its slot."""
    depth, _, L, K = paths.shape
    idx = _indices(indices, arity**depth, f"path depth {depth} of arity {arity}", leaves.device)
    slots = torch.arange(arity, device=idx.device)[:, None]
    cur = leaves
    for d in range(depth):
        slot = idx % arity
        j = (slots - (slots > slot).long()).clamp(max=arity - 2)  # the sibling each slot reads
        sibs = paths[d].gather(0, j[:, None, :].expand(arity, L, K))
        children = torch.where((slots == slot)[:, None, :], cur[None], sibs)
        cur = compress_children(cfg, children, tag, backend)
        idx = idx // arity
    return (cur == root[:, None]).all(0)
