"""The Rescue family: what the harness needs of a configuration whose
``family`` is ``rescue`` (Rescue Prime Optimized at Miden's shape).

* ``program_config``: the program's RPO config of the configuration's
  field (``get_rpo_parameters``), refused if its modulus, width, rate,
  capacity, alpha, rounds, round order or MDS matrix are not the ones the
  configuration states;
* ``control_config``: the same with its last round and its two constant
  rows dropped, the cut that would tempt a faster hash (the control of
  ``correct``);
* ``Reference``: the plain reference's Miden sponge and merge;
* ``permutations_bound_s``: the least time of n permutations on the card.
"""

from __future__ import annotations

import dataclasses

from spongebench.reference.rescue import Rescue, circulant, hash_elements, merge
from spongebench.roofline import GOLDILOCKS_P, chain_products

STATED = ("modulus", "width", "rate", "capacity", "alpha", "rounds", "mds_first")


def program_config(st, config: dict):
    fs = st.get_field(config["field"])
    cfg = st.get_rpo_parameters(fs)
    got = dict(zip(STATED, (fs.modulus, cfg.t, cfg.rate, cfg.capacity, cfg.alpha, cfg.rounds, cfg.mds_first)))
    if tuple(got.values()) != tuple(config[k] for k in STATED):
        raise ValueError(f"the program's RPO config {got} is not the configuration's")
    if cfg.mds != circulant(tuple(config["mds"])):
        raise ValueError("the program's MDS matrix is not the configuration's circulant")
    return cfg


def control_config(st, config: dict):
    cfg = program_config(st, config)
    return dataclasses.replace(cfg, rounds=cfg.rounds - 1, rc=cfg.rc[: 2 * (cfg.rounds - 1)])


class Reference:
    """The configuration's permutation, worked out by the plain reference
    from the Grain LFSR, behind the two calls a job's judge makes."""

    def __init__(self, config: dict):
        self.params = Rescue.generate(config["modulus"], config["width"], config["alpha"], config["rounds"],
                                      config["mds"], config["mds_first"])
        self.rate, self.capacity = config["rate"], config["capacity"]
        self.p = self.params.p

    def hash(self, elems, outputs: int) -> list:
        return hash_elements(self.params, elems, self.rate, self.capacity, outputs)

    def compress(self, left, right) -> list:
        return merge(self.params, left, right, self.capacity)


def permutation_products(config: dict) -> int:
    """Wide multiply-adds of one Rescue permutation with two 32-bit words an
    element (Goldilocks, plain form, the reduction counted as none): a
    product 4, a squaring 3 (``roofline.py``'s rule); per round t S-boxes
    x^alpha and t x^(1/alpha), each its shortest chain, and two MDS layers
    of t rows, each row t words times entries below 2^5, 2 t."""
    if config["modulus"] != GOLDILOCKS_P:
        raise ValueError("the count is of two-word elements: Goldilocks")
    t, alpha = config["width"], config["alpha"]
    inv_alpha = pow(alpha, -1, config["modulus"] - 1)
    sboxes = t * (chain_products(alpha, 3, 4) + chain_products(inv_alpha, 3, 4))
    return config["rounds"] * (sboxes + 2 * t * 2 * t)


def permutations_bound_s(peaks, config: dict, n: int) -> float:
    """Least seconds of n permutations: their wide products at the peak,
    or their states (24-bit limbs, as the program's planes hold them) read
    and written once at the HBM rate, whichever is longer."""
    ops_s = n * permutation_products(config) / peaks.wide_per_s
    limbs = -(-(config["modulus"].bit_length() + 4) // 24)
    bytes_s = n * 2 * config["width"] * limbs * 4 / peaks.hbm_bytes_per_s
    return max(ops_s, bytes_s)
