"""The commitment job: the generator of every traffic mix whose ``job`` is
``commit`` (``traffic/<mix>.json``), and the comparison that judges it.

A commitment takes leaves that are already on the device and ends with its
root, and its openings if the mix asks for any, copied to the host.  Its
steps are the program's public calls:

* ``hash_leaves``: each leaf of ``leaf_elems`` elements is hashed into a
  digest of the configuration's ``digest_elems`` (``hash.hash_elements``);
  otherwise each leaf is a digest already (``leaf_elems == digest_elems``);
* the Merkle tree over the digests, all levels kept (``hash.merkle_tree``
  for one-element digests, ``hash.merkle_tree_wide`` for wider ones);
* ``openings`` authentication paths at indices drawn from the seed
  (``hash.merkle_open_batch``).

``sets`` leaf sets are made from the seed and taken in turn, so no
commitment repeats the one before it.  A job's units are its leaves.

The judge, once the window has closed, compares against the plain
reference.  Every number is a count of mismatches with the limit 0: the
configuration states exact field arithmetic and canonical outputs.

* ``answer_mismatches``: commitments whose root or openings, as copied to
  the host, differ from the tree kept from the latest commitment of their
  leaf set (every commitment of the window);
* ``leaf_mismatches``: sampled leaves whose digest differs from the
  reference's sponge over the benchmark's own leaf (hashed leaves only);
* ``node_mismatches``: sampled nodes of every level above the leaves that
  differ from the reference's compression of their two children as the
  program's level below holds them, or are not canonical;
* ``proof_failures``: openings of each kept tree's latest commitment whose
  root, recomputed by the reference from the benchmark's leaf and the
  opened siblings, differs from the root the program handed back.

The node check follows the program level by level from its own children;
the leaf check starts it from the benchmark's inputs and the proofs join
the two up to the root, so no level is taken on trust.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spongebench.data import random_plane, sub_seed
from spongebench.reference import planes

PARAMETERS = ("leaves_log2", "leaf_elems", "hash_leaves", "openings", "sets")
SAMPLES = 64  # nodes drawn per level (and leaves), besides the first and the last


@dataclass
class Commitment:
    """What one commitment handed back to the host, and where it came from."""

    leaf_set: int
    indices: np.ndarray  # (K,) opened leaves
    root: torch.Tensor  # (d, L), host
    paths: torch.Tensor  # (depth, d, L, K), host
    units: int  # leaves
    ms: float = 0.0


class Job:
    """Inputs of one cell on the device and the timed call over them."""

    def __init__(self, cfg, config: dict, traffic: dict, device, seed: int):
        from sponge_tpu_torch import hash as sthash

        missing = [k for k in PARAMETERS if k not in traffic]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        self.cfg, self.seed, self.hash = cfg, seed, sthash
        self.n = 1 << int(traffic["leaves_log2"])
        self.k = int(traffic["leaf_elems"])
        self.d = int(config["digest_elems"])
        self.hash_leaves = bool(traffic["hash_leaves"])
        self.openings = int(traffic["openings"])
        if not self.hash_leaves and self.k != self.d:
            raise ValueError("leaves that are not hashed must be digests: leaf_elems == digest_elems")
        p, L = config["modulus"], planes.nlimbs(config["modulus"])
        self.inputs = [random_plane(p, (self.k, L, self.n), sub_seed(seed, 1, s), device)
                       for s in range(int(traffic["sets"]))]
        self.kept = [None] * len(self.inputs)  # the levels of each set's latest commitment
        self.warm = len(self.inputs)  # one untimed commitment per set warms every shape

    @property
    def permutations(self) -> int:
        """Permutations of one commitment: the leaf sponges' (the absorbs
        that fill the rate, then the squeeze) and one per tree node."""
        rate = self.cfg.rate
        per_leaf = -(-self.k // rate) + (-(-self.d // rate) - 1) if self.hash_leaves else 0
        return self.n * per_leaf + self.n - 1

    def indices(self, j: int) -> np.ndarray:
        """The leaves that commitment ``j`` opens."""
        rng = np.random.default_rng(sub_seed(self.seed, 2, j))
        return rng.integers(0, self.n, self.openings, dtype=np.int64)

    def run(self, j: int) -> Commitment:
        """Commitment ``j``, on leaf set ``j mod sets``."""
        s = j % len(self.inputs)
        idx = self.indices(j)
        leaves = self.inputs[s]
        digests = self.hash.hash_elements(self.cfg, leaves, self.d) if self.hash_leaves else leaves
        if self.d == 1:
            levels = [lv[None] for lv in self.hash.merkle_tree(self.cfg, digests[0])]
        else:
            levels = self.hash.merkle_tree_wide(self.cfg, digests)
        root = levels[-1][..., 0]
        paths = self.hash.merkle_open_batch(levels, idx) if self.openings else root.new_empty((0,))
        out = Commitment(s, idx, root.cpu(), paths.cpu(), self.n)
        self.kept[s] = levels
        return out

    def judge(self, ref, records: list, seed: int) -> tuple:
        """(checks, failed): each compared number with its limit, and for
        each of ``records`` whether it failed.  ``ref`` is the family's
        reference (``p``, ``hash``, ``compress``)."""
        p = ref.p
        rng = np.random.default_rng(sub_seed(seed, 3))
        bad_sets = set()
        leaf_bad = node_bad = proof_bad = 0
        for s, levels in enumerate(self.kept):
            if levels is None:
                continue
            inputs = self.inputs[s]
            before = leaf_bad + node_bad + proof_bad
            if self.hash_leaves:
                idx = _sample(self.n, rng)
                rows = _elements(p, inputs, idx)
                got = _elements(p, levels[0], idx)
                leaf_bad += sum(ref.hash(row, self.d) != g for row, g in zip(rows, got))
            for i in range(1, len(levels)):
                idx = _sample(levels[i].shape[-1], rng)
                left = _elements(p, levels[i - 1], 2 * idx)
                right = _elements(p, levels[i - 1], 2 * idx + 1)
                got = _elements(p, levels[i], idx)
                node_bad += sum(None in lft + rgt or ref.compress(lft, rgt) != g
                                for lft, rgt, g in zip(left, right, got))
            last = [r for r in records if r.leaf_set == s]
            if self.openings and last:
                proof_bad += self._failed_proofs(ref, inputs, last[-1])
            if leaf_bad + node_bad + proof_bad > before:
                bad_sets.add(s)
        wrong = [not _answers_match(self.kept[r.leaf_set], r) for r in records]
        failed = [w or r.leaf_set in bad_sets for w, r in zip(wrong, records)]
        checks = {"answer_mismatches": (sum(wrong), 0)}
        if self.hash_leaves:
            checks["leaf_mismatches"] = (leaf_bad, 0)
        checks["node_mismatches"] = (node_bad, 0)
        if self.openings:
            checks["proof_failures"] = (proof_bad, 0)
        return checks, failed

    def _failed_proofs(self, ref, inputs, r) -> int:
        p = ref.p
        root = [planes.decode(p, r.root[e].numpy()[:, None])[0] for e in range(self.d)]
        leaves = _elements(p, inputs, r.indices)
        paths = r.paths.numpy()  # (depth, d, L, K)
        bad = 0
        for k, (leaf, index) in enumerate(zip(leaves, r.indices.tolist())):
            cur = ref.hash(leaf, self.d) if self.hash_leaves else leaf
            for level in paths:
                sib = [planes.decode(p, level[e][:, k : k + 1])[0] for e in range(self.d)]
                if None in sib:
                    cur = None
                    break
                cur = ref.compress(cur, sib) if index & 1 == 0 else ref.compress(sib, cur)
                index >>= 1
            bad += cur is None or None in root or cur != root
        return bad


def _sample(n: int, rng) -> np.ndarray:
    if n <= SAMPLES + 2:
        return np.arange(n)
    drawn = rng.choice(n, SAMPLES, replace=False)
    return np.unique(np.concatenate([drawn, [0, n - 1]]))


def _elements(p: int, plane: torch.Tensor, idx: np.ndarray) -> list:
    """(e, L, n) plane -> for each index, its e elements (None where one is
    not canonical)."""
    cols = plane.index_select(-1, torch.as_tensor(idx, device=plane.device)).cpu().numpy()
    per_row = [planes.decode(p, row) for row in cols]  # e lists of K
    return [list(vals) for vals in zip(*per_row)]


def _answers_match(levels, r) -> bool:
    if levels is None:
        return False
    if not torch.equal(r.root, levels[-1][..., 0].cpu()):
        return False
    if not len(r.indices):
        return True
    idx = torch.as_tensor(r.indices, device=levels[0].device)
    want = torch.stack([lv.index_select(-1, (idx >> i) ^ 1) for i, lv in enumerate(levels[:-1])])
    return torch.equal(r.paths, want.cpu())
