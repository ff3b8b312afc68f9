"""Batched GMiMC-erf permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/gmimc/permutation.py``.  ``GmimcPermutation``
is the family module of ``family.py`` over kernel 8 (``ops/gmimc.py``) and
its plain version; backends "auto", "kernel" and "plain" as described
there.
"""

from __future__ import annotations

import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.gmimc import gmimc_permute, gmimc_permute_plain
from .config import GmimcConfig, kernel_constants


class GmimcPermutation(FamilyPermutation):
    """The GMiMC-erf permutation of one config: kernel 8 and its plain
    version."""

    kernel = staticmethod(gmimc_permute)
    plain = staticmethod(gmimc_permute_plain)
    constants = staticmethod(kernel_constants)


def batched_gmimc_permute(cfg: GmimcConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched GMiMC-erf permutation (``family``
    backends)."""
    return permutation_for(GmimcPermutation, cfg, state.device)(state, backend)
