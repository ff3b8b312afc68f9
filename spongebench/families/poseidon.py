"""The Poseidon family: what the harness needs of a configuration whose
``family`` is ``poseidon``.

* ``program_config``: the program's default config of the configuration's
  field and rate, refused if it is not the one the configuration states;
* ``control_config``: the same with its last partial round dropped, the
  cut that would tempt a faster hash (the control of ``correct``);
* ``Reference``: the plain reference's sponge and 2-to-1 compression;
* ``permutations_bound_s``: the least time of n permutations on the card.
"""

from __future__ import annotations

import dataclasses

from spongebench.reference.poseidon import Poseidon, compress, hash_elements
from spongebench.roofline import poseidon_bound_s

STATED = ("modulus", "capacity", "alpha", "full_rounds", "partial_rounds")


def program_config(st, config: dict):
    fs = st.get_field(config["field"])
    cfg = st.get_default_poseidon_parameters(fs, config["rate"])
    got = (fs.modulus, cfg.capacity, cfg.alpha, cfg.full_rounds, cfg.partial_rounds)
    if got != tuple(config[k] for k in STATED):
        raise ValueError(f"the program's default config {dict(zip(STATED, got))} is not the configuration's")
    return cfg


def control_config(st, config: dict):
    cfg = program_config(st, config)
    cut = cfg.full_rounds // 2 + cfg.partial_rounds - 1  # the last partial round
    return dataclasses.replace(cfg, partial_rounds=cfg.partial_rounds - 1,
                               ark=cfg.ark[:cut] + cfg.ark[cut + 1:])


class Reference:
    """The configuration's permutation, worked out by the plain reference
    from the Grain LFSR, behind the two calls a job's judge makes."""

    def __init__(self, config: dict):
        self.params = Poseidon.generate(config["modulus"], config["rate"], config["capacity"],
                                        config["alpha"], config["full_rounds"], config["partial_rounds"])
        self.p = self.params.p

    def hash(self, elems, outputs: int) -> list:
        return hash_elements(self.params, elems, outputs)

    def compress(self, left, right) -> list:
        return compress(self.params, left, right)


def permutations_bound_s(peaks, config: dict, n: int) -> float:
    return poseidon_bound_s(peaks, config["modulus"], config["rate"] + config["capacity"], config["alpha"],
                            config["full_rounds"], config["partial_rounds"], n)
