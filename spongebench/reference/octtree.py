"""Plain arity-k Merkle tree with a domain-tagged node hash over Python
ints: the benchmark's reference for Filecoin's sealing trees.

Written from neptune's Poseidon as rust-fil-proofs' ``PoseidonHasher``
runs it (storage-proofs-core ``hasher/poseidon.rs``; neptune
``src/poseidon.rs``: the state is the domain tag followed by the
preimage, the hash is element 1 of the permuted state; ``HashType::
MerkleTree``'s tag is 2^arity - 1), not from the program under test,
which it never imports.  The permutation is ``poseidon.py``'s dense
``Poseidon.permute`` at t = k + 1, capacity 1.

Departure from the published description: the round constants and the MDS
matrix are ``poseidon.py``'s Grain LFSR draws (ark-sponge's
``find_poseidon_ark_and_mds``), not neptune's tables (no published vectors
in the repo); the shapes are neptune's.
"""

from __future__ import annotations

from spongebench.reference.poseidon import Poseidon


def merkle_tag(arity: int) -> int:
    """Neptune's ``HashType::MerkleTree`` tag of an arity-k tree."""
    return (1 << arity) - 1


def tagged_hash(params: Poseidon, tag: int, children) -> int:
    """One node: the permutation of [tag, c_0, ..., c_{k-1}] (zero-padded
    to the width), element 1 (the first after the capacity)."""
    children = list(children)
    if params.capacity != 1 or not 0 < len(children) <= params.rate:
        raise ValueError(f"a tagged node hash has capacity 1 and 1 to rate children; got "
                         f"capacity {params.capacity}, {len(children)} children")
    state = [tag % params.p] + children + [0] * (params.rate - len(children))
    return params.permute(state)[params.capacity]


def tree(params: Poseidon, leaves, arity: int, tag: int) -> list:
    """Every level of the tree, leaves first, to the one root; the leaf
    count a power of ``arity``."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        below = levels[-1]
        if len(below) % arity:
            raise ValueError(f"{len(below)} nodes are not a multiple of the arity {arity}")
        levels.append([tagged_hash(params, tag, below[i : i + arity]) for i in range(0, len(below), arity)])
    return levels


def root(params: Poseidon, leaves, arity: int, tag: int) -> int:
    return tree(params, leaves, arity, tag)[-1][0]
