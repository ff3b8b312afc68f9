"""The Poseidon2 family: what the harness needs of a configuration whose
``family`` is ``poseidon2``.

* ``program_config``: the program's default Poseidon2 config of the
  configuration's field and rate, refused if it is not the one the
  configuration states;
* ``control_config``: the same with its last internal round dropped, the
  cut that would tempt a faster hash (the control of ``correct``);
* ``Reference``: the plain reference's padding-free sponge and truncated
  permutation (the modes of Plonky3 that the configuration states);
* ``permutations_bound_s``: the least time of n permutations on the card.
"""

from __future__ import annotations

import dataclasses

from spongebench.reference.poseidon2 import Poseidon2, padding_free_hash, truncated_compress
from spongebench.roofline import chain_products

STATED = ("modulus", "width", "capacity", "alpha", "full_rounds", "partial_rounds")
WORD_LIMIT = 1 << 31  # fields one 32-bit word holds with room for a sum


def program_config(st, config: dict):
    fs = st.get_field(config["field"])
    cfg = st.get_default_poseidon2_parameters(fs, config["rate"])
    got = (fs.modulus, cfg.t, cfg.capacity, cfg.alpha, cfg.full_rounds, cfg.partial_rounds)
    if got != tuple(config[k] for k in STATED):
        raise ValueError(f"the program's default config {dict(zip(STATED, got))} is not the configuration's")
    return cfg


def control_config(st, config: dict):
    cfg = program_config(st, config)
    return dataclasses.replace(cfg, partial_rounds=cfg.partial_rounds - 1, internal_rc=cfg.internal_rc[:-1])


class Reference:
    """The configuration's permutation, worked out by the plain reference
    from the Grain LFSR, behind the two calls a job's judge makes."""

    def __init__(self, config: dict):
        self.params = Poseidon2.generate(config["modulus"], config["width"], config["alpha"],
                                         config["full_rounds"], config["partial_rounds"])
        self.rate = config["rate"]
        self.p = self.params.p

    def hash(self, elems, outputs: int) -> list:
        return padding_free_hash(self.params, elems, self.rate, outputs)

    def compress(self, left, right) -> list:
        return truncated_compress(self.params, left, right)


def permutation_products(config: dict) -> tuple:
    """(wide, narrow) multiply-adds of one Poseidon2 permutation with one
    32-bit word an element: a Montgomery product is 2 wide and 1 narrow;
    an S-box is x^alpha's shortest chain of them, t a full round and one a
    partial round; M_I takes t products by its diagonal a partial round;
    M_E's small integers are additions, and count nothing."""
    if config["modulus"] >= WORD_LIMIT:
        raise ValueError("the count is of one-word elements: a field below 2^31")
    t, rounds_f, rounds_p = config["width"], config["full_rounds"], config["partial_rounds"]
    products = chain_products(config["alpha"], 1, 1) * (rounds_f * t + rounds_p) + rounds_p * t
    return 2 * products, products


def permutations_bound_s(peaks, config: dict, n: int) -> float:
    """Least seconds of n permutations: their products at the integer
    peaks, or their states (24-bit limbs, as the program's planes hold
    them) read and written once at the HBM rate, whichever is longer."""
    wide, narrow = permutation_products(config)
    ops_s = n * (wide / peaks.wide_per_s + narrow / peaks.narrow_per_s)
    limbs = -(-(config["modulus"].bit_length() + 4) // 24)
    bytes_s = n * 2 * config["width"] * limbs * 4 / peaks.hbm_bytes_per_s
    return max(ops_s, bytes_s)
