"""Batched Poseidon2 permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/poseidon2/permutation.py``.  ``Poseidon2Permutation``
is the family module of ``family.py`` over kernel 3 (``ops/poseidon2.py``)
and its plain version; backends "auto", "kernel" and "plain" as described
there.  On kernel 3's one-word body it also has Plonky3's overwrite sponge
in one launch (``overwrite``), which ``poseidon.permutation``
``overwrite_permute`` takes.
"""

from __future__ import annotations

import functools

import numpy as np

from ..family import FamilyPermutation
from ..fields import one_word
from ..ops.poseidon2 import overwrite_permute_p2, permute_p2, permute_p2_plain
from ..poseidon.config import mont_limb_rows
from ..poseidon.permutation import batched_permute
from .config import Poseidon2Config, kernel_constants


@functools.lru_cache(maxsize=None)
def device_constants2(cfg: Poseidon2Config):
    """Round constants and matrices in the JAX package's device layout
    (numpy), with the port's 24-bit Montgomery limbs:

    * ``ext``: (R_F, t, L, 1) int32,
    * ``internal``: (R_P, L, 1) int32,
    * ``mat_e``: (t, t) int32 small ints,
    * ``diag_m1``: (t, L, 1) int32, Montgomery form of mu - 1.
    """
    fs = cfg.field
    internal = (
        mont_limb_rows(fs, [cfg.internal_rc])[0]
        if cfg.partial_rounds
        else np.zeros((0, fs.nlimbs), dtype=np.int32)
    )
    return {
        "ext": mont_limb_rows(fs, cfg.external_rc)[..., None],
        "internal": internal[..., None],
        "mat_e": np.asarray(cfg.mat_e, dtype=np.int32),
        "diag_m1": mont_limb_rows(fs, [cfg.diag_m1])[0][..., None],
    }


class Poseidon2Permutation(FamilyPermutation, config=Poseidon2Config):
    """The Poseidon2 permutation of one config: kernel 3 and its plain
    version.  ``overwrites`` where kernel 3 takes its one-word body (a
    field below 2^31, the test ``ops/bounds.py`` ``check_p2_bounds``
    makes), which has the overwrite sponge."""

    kernel = staticmethod(permute_p2)
    plain = staticmethod(permute_p2_plain)
    constants = staticmethod(kernel_constants)

    def __init__(self, cfg: Poseidon2Config, device):
        super().__init__(cfg, device)
        self.overwrites = one_word(cfg.field)

    def overwrite(self, views: tuple, width: int, out_rows: int):
        """Kernel 3's overwrite sponge (``overwrite_permute_p2``)."""
        return overwrite_permute_p2(self.cfg, self.consts, views, width, out_rows)


batched_permute2 = batched_permute  # the JAX package's name
