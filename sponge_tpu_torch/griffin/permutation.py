"""Batched Griffin-pi permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/griffin/permutation.py``.  ``GriffinPermutation``
is the family module of ``family.py`` over kernel 6 (``ops/griffin.py``) and
its plain version; backends "auto", "kernel" and "plain" as described
there.
"""

from __future__ import annotations

import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.griffin import griffin_permute, griffin_permute_plain
from .config import GriffinConfig, kernel_constants


class GriffinPermutation(FamilyPermutation):
    """The Griffin-pi permutation of one config: kernel 6 and its plain
    version."""

    kernel = staticmethod(griffin_permute)
    plain = staticmethod(griffin_permute_plain)
    constants = staticmethod(kernel_constants)


def batched_griffin_permute(cfg: GriffinConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched Griffin-pi permutation (``family``
    backends)."""
    return permutation_for(GriffinPermutation, cfg, state.device)(state, backend)
