"""The Miden job: a commitment as a Miden VM prover makes it with RPO256
(``jobs/commit.py`` with its inputs, openings and judge), whose calls are
Miden's modes:

* each row of ``leaf_elems`` elements is hashed into ``digest_elems`` by
  the length-tagged overwrite sponge (``hash.rpo_hash_elements``,
  ``Rpo256::hash_elements``);
* the tree merges two digests with one permutation over a zero state's
  rate (``hash.merkle_tree_wide``, ``Rpo256::merge``), all levels kept.

The configuration states these modes (``absorb`` "rpo_overwrite",
``compression`` "absorb"), and its family's reference computes them.  A
program without the leaf hash fails before any input is made.
"""

from __future__ import annotations

from spongebench.jobs import commit

STATED = {"absorb": "rpo_overwrite", "compression": "absorb"}


class _Calls:
    """The program's hash module under the names the commit job calls: its
    leaf hash is Miden's sponge, its wide tree Miden's merge tree."""

    def __init__(self, sthash):
        self.hash_elements = sthash.rpo_hash_elements
        self.merkle_tree_wide = sthash.merkle_tree_wide
        self.merkle_open_batch = sthash.merkle_open_batch


class Job(commit.Job):
    def __init__(self, cfg, config: dict, traffic: dict, device, seed: int):
        from sponge_tpu_torch import hash as sthash

        wrong = {k: config.get(k) for k, v in STATED.items() if config.get(k) != v}
        if wrong:
            raise ValueError(f"the Miden job runs {STATED}; the configuration states {wrong}")
        calls = _Calls(sthash)  # raises on a program without the leaf hash
        super().__init__(cfg, config, traffic, device, seed)
        self.hash = calls
