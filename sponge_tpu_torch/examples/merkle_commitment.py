"""Merkle commitment: build a tree on the card, open a batch of indices in
one gather, verify the batch in one pass, and refuse a tampered leaf.

This is the STARK/FRI commitment shape: commit to 2^k leaves, the verifier
samples q random indices, the prover opens all q paths at once.

Run: python -m sponge_tpu_torch.examples.merkle_commitment [--device cpu] [--lanes N] [--proofs Q]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import GOLDILOCKS_FR as F
from .. import get_default_monolith_parameters
from ..fields import mont_tensor_to_ints
from ..hash import merkle_open_batch, merkle_tree, merkle_verify_batch
from . import describe, device_of

TAMPERED = 3  # the proof whose leaf is changed
SEED = 1  # the leaves' and indices' generator


def leaf_values(lanes: int, proofs: int):
    """The leaves' canonical values and the opened indices."""
    rng = np.random.default_rng(SEED)
    vals = [int(v) % F.modulus for v in rng.integers(0, 1 << 62, size=lanes)]
    return vals, rng.integers(0, lanes, size=proofs)


def main(device="cuda", lanes: int = 1 << 10, proofs: int = 32):
    """Commit to ``lanes`` (a power of two) Monolith/Goldilocks leaves and
    open and verify ``proofs`` (at least 4) of them.  Returns the root."""
    if lanes < 2 or lanes & (lanes - 1) or proofs <= TAMPERED:
        raise ValueError(f"need a power-of-two leaf count >= 2 and more than {TAMPERED} proofs")
    dev = device_of(device)
    # Any family drives the Merkle layer through its config; Monolith over
    # Goldilocks is the small-field throughput choice.
    cfg = get_default_monolith_parameters(F)
    vals, indices = leaf_values(lanes, proofs)
    leaves = torch.from_numpy(F.ints_to_mont_plane(vals)).to(dev)  # (L, N)
    levels = merkle_tree(cfg, leaves)
    root = levels[-1][:, 0]

    idx = torch.from_numpy(indices).to(dev)
    paths = merkle_open_batch(levels, idx)  # (depth, L, q) sibling planes
    opened = leaves[:, idx]
    ok = merkle_verify_batch(cfg, root, opened, paths, idx)
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} of {proofs} proofs failed")

    bad = opened.clone()
    wrong = (vals[int(indices[TAMPERED])] + 1) % F.modulus
    bad[:, TAMPERED] = torch.from_numpy(F.ints_to_mont_plane([wrong])[:, 0]).to(dev)
    refused = merkle_verify_batch(cfg, root, bad, paths, idx)
    others = torch.ones(proofs, dtype=torch.bool, device=dev)
    others[TAMPERED] = False
    if bool(refused[TAMPERED]) or not bool(refused[others].all()):
        raise AssertionError("a tampered leaf must fail its own proof and no other")

    print(f"committed {lanes} Goldilocks leaves on {describe(dev)}; "
          f"opened+verified {proofs} proofs in 2 passes; the tampered leaf fails its proof alone")
    root_int = mont_tensor_to_ints(F, root[:, None])[0]
    print(f"root = {root_int}")
    return root_int


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=1 << 10, help="leaves (a power of two)")
    ap.add_argument("--proofs", type=int, default=32)
    args = ap.parse_args()
    main(args.device, args.lanes, args.proofs)
