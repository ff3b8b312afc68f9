"""Batched Rescue-Prime permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/rescue/permutation.py``.  ``RescuePermutation``
is the family module of ``family.py`` over kernel 5 (``ops/rescue.py``) and
its plain version; backends "auto", "kernel" and "plain" as described there.
It holds the limb body's constants (``consts``) and the two-word body's
(``words``, empty where that body does not run).
"""

from __future__ import annotations

import functools

from ..family import FamilyPermutation
from ..ops.rescue import rescue_permute, rescue_permute_plain, word_constants
from ..poseidon.config import mont_limb_rows
from ..poseidon.permutation import batched_permute
from .config import RescueConfig, kernel_constants


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: RescueConfig):
    """``(rc, mds)`` in the JAX package's device layout (numpy) with the
    port's 24-bit Montgomery limbs: rc (2N, t, L, 1), mds (t, t, L, 1)."""
    fs = cfg.field
    return mont_limb_rows(fs, cfg.rc)[..., None], mont_limb_rows(fs, cfg.mds)[..., None]


class RescuePermutation(FamilyPermutation, config=RescueConfig):
    """The Rescue-Prime permutation of one config: kernel 5 and its plain
    version."""

    plain = staticmethod(rescue_permute_plain)
    constants = staticmethod(kernel_constants)
    extra = {"words": word_constants}

    def kernel(self, cfg: RescueConfig, consts, state):
        return rescue_permute(cfg, consts, state, self.words)


batched_rescue_permute = batched_permute  # the JAX package's name
