"""Fixed-shape Poseidon hashing on the duplex sponge semantics.

Counterpart of ``sponge_tpu/hash.py:23-115``: batched 2-to-1 compression
(one permutation per node), fixed-length hashing of element blocks, and the
Merkle root.  The kernels take any batch width, so levels are neither
chunked nor padded (the JAX package pads to reuse XLA compilations).
"""

from __future__ import annotations

import torch

from .poseidon.permutation import SpongeConfig, batched_permute, zero_state
from .transcript import add_rows


def compress_pairs(
    cfg: SpongeConfig, left: torch.Tensor, right: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """(L, B) x (L, B) Montgomery planes -> (L, B): a fresh sponge absorbs
    [l, r] and squeezes one native element; the one permutation is the
    absorb -> squeeze flip."""
    if cfg.rate < 2:
        raise ValueError("2-to-1 compression needs rate >= 2")
    L, B = left.shape
    zeros = torch.zeros((cfg.capacity, L, B), dtype=torch.int32, device=left.device)
    tail = torch.zeros((cfg.rate - 2, L, B), dtype=torch.int32, device=left.device)
    state = torch.cat([zeros, left[None].int(), right[None].int(), tail])
    return batched_permute(cfg, state, backend)[cfg.capacity]


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


def merkle_root(cfg: SpongeConfig, leaves: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(L, N) Montgomery leaf plane -> (L,) root; N a power of two.  Each
    level compresses contiguous pairs with one batched permutation."""
    L, N = leaves.shape
    if N < 1 or N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    level = leaves
    while level.shape[-1] > 1:
        pairs = level.reshape(L, level.shape[-1] // 2, 2)
        level = compress_pairs(cfg, pairs[..., 0], pairs[..., 1], backend)
    return level[:, 0]
