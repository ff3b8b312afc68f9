"""Batched Poseidon2 permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/poseidon2/permutation.py``.  ``Poseidon2Permutation``
is the family module of ``family.py`` over kernel 3 (``ops/poseidon2.py``)
and its plain version; backends "auto", "kernel" and "plain" as described
there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.poseidon2 import permute_p2, permute_p2_plain
from ..poseidon.config import mont_limb_rows
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


class Poseidon2Permutation(FamilyPermutation):
    """The Poseidon2 permutation of one config: kernel 3 and its plain version."""

    kernel = staticmethod(permute_p2)
    plain = staticmethod(permute_p2_plain)
    constants = staticmethod(kernel_constants)


def batched_permute2(cfg: Poseidon2Config, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched Poseidon2 permutation (``family`` backends)."""
    return permutation_for(Poseidon2Permutation, cfg, state.device)(state, backend)
