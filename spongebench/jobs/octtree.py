"""The octtree job: the generator of every traffic mix whose ``job`` is
``octtree`` (``traffic/<mix>.json``), and the comparison that judges it.

A commitment is Filecoin's base tree as PC2 builds it: leaves already on
the device, an arity-k tree whose node hash starts from a domain tag in the
capacity (``hash.merkle_tree_arity``; the configuration states ``arity``
and ``domain_tag``), every level kept, the root copied to the host.  No
path is opened: the mix's ``openings`` must be 0.  ``sets`` leaf sets are
made from the seed and taken in turn, so no commitment repeats the one
before it.  A job's units are its leaves.  A program without the arity-k
tree fails before any input is made.

The judge, once the window has closed, compares against the plain
reference (``reference/octtree.py`` over the family's permutation).  Every
number is a count of mismatches with the limit 0: the configuration states
exact field arithmetic and canonical outputs.

* ``answer_mismatches``: commitments whose root, as copied to the host,
  differs from the tree kept from the latest commitment of their leaf set;
* ``node_mismatches``: sampled nodes of every level above the leaves
  (``commit.SAMPLES`` drawn, and both ends) that differ from the
  reference's tagged hash of their k children as the program's level below
  holds them (the benchmark's own leaves at the first level), or are not
  canonical.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spongebench.data import random_plane, sub_seed
from spongebench.jobs.commit import _elements, _sample
from spongebench.reference import planes
from spongebench.reference.octtree import tagged_hash

PARAMETERS = ("leaves_log2", "openings", "sets")
STATED = ("arity", "domain_tag")


@dataclass
class Tree:
    """What one commitment handed back to the host, and where it came from."""

    leaf_set: int
    root: torch.Tensor  # (L,), host
    units: int  # leaves
    ms: float = 0.0


class Job:
    """Inputs of one cell on the device and the timed call over them."""

    def __init__(self, cfg, config: dict, traffic: dict, device, seed: int):
        from sponge_tpu_torch import hash as sthash

        missing = [k for k in STATED if k not in config]
        if missing:
            raise ValueError(f"the octtree job needs a configuration that states {missing}")
        self.tree = sthash.merkle_tree_arity  # raises on a program without the arity-k tree
        missing = [k for k in PARAMETERS if k not in traffic]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        if int(traffic["openings"]) or int(config.get("digest_elems", 1)) != 1:
            raise ValueError("the octtree job builds one-element trees and opens no paths")
        self.cfg, self.seed = cfg, seed
        self.arity, self.tag = int(config["arity"]), int(config["domain_tag"])
        self.n = m = 1 << int(traffic["leaves_log2"])
        while self.arity >= 2 and m % self.arity == 0:
            m //= self.arity
        if self.arity < 2 or m != 1:
            raise ValueError(f"2^{traffic['leaves_log2']} leaves are not a power of the arity {self.arity}")
        p = config["modulus"]
        self.inputs = [random_plane(p, (planes.nlimbs(p), self.n), sub_seed(seed, 1, s), device)
                       for s in range(int(traffic["sets"]))]
        self.kept = [None] * len(self.inputs)  # the levels of each set's latest commitment
        self.warm = len(self.inputs)  # one untimed commitment per set warms every shape

    @property
    def permutations(self) -> int:
        """Permutations of one commitment: one a node, (n - 1) / (k - 1)."""
        return (self.n - 1) // (self.arity - 1)

    def run(self, j: int) -> Tree:
        """Commitment ``j``, on leaf set ``j mod sets``."""
        s = j % len(self.inputs)
        levels = self.tree(self.cfg, self.inputs[s], self.arity, self.tag)
        out = Tree(s, levels[-1][:, 0].cpu(), self.n)
        self.kept[s] = levels
        return out

    def judge(self, ref, records: list, seed: int) -> tuple:
        """(checks, failed): each compared number with its limit, and for
        each of ``records`` whether it failed.  ``ref`` is the family's
        reference (``p``, ``params``: the permutation)."""
        p, k = ref.p, self.arity
        rng = np.random.default_rng(sub_seed(seed, 3))
        bad_sets = set()
        node_bad = 0
        for s, levels in enumerate(self.kept):
            if levels is None:
                continue
            before = node_bad
            for i in range(1, len(levels)):
                idx = _sample(levels[i].shape[-1], rng)
                kids = _elements(p, levels[i - 1][None], (idx[:, None] * k + np.arange(k)).reshape(-1))
                got = _elements(p, levels[i][None], idx)
                for c, (g,) in enumerate(got):
                    children = [v for (v,) in kids[c * k : (c + 1) * k]]
                    node_bad += None in children or g is None or tagged_hash(ref.params, self.tag, children) != g
            if node_bad > before:
                bad_sets.add(s)
        wrong = [not _root_matches(self.kept[r.leaf_set], r) for r in records]
        failed = [w or r.leaf_set in bad_sets for w, r in zip(wrong, records)]
        return {"answer_mismatches": (sum(wrong), 0), "node_mismatches": (node_bad, 0)}, failed


def _root_matches(levels, r) -> bool:
    return levels is not None and torch.equal(r.root, levels[-1][:, 0].cpu())
