"""Batched Anemoi permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/anemoi/permutation.py``: X = state[:l] and
Y = state[l:].  ``AnemoiPermutation`` is the family module of ``family.py``
over kernel 7 (``ops/anemoi.py``) and its plain version; backends "auto",
"kernel" and "plain" as described there.
"""

from __future__ import annotations

import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.anemoi import anemoi_permute, anemoi_permute_plain
from .config import AnemoiConfig, kernel_constants


class AnemoiPermutation(FamilyPermutation):
    """The Anemoi permutation of one config: kernel 7 and its plain
    version."""

    kernel = staticmethod(anemoi_permute)
    plain = staticmethod(anemoi_permute_plain)
    constants = staticmethod(kernel_constants)


def batched_anemoi_permute(cfg: AnemoiConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched Anemoi permutation (``family`` backends)."""
    return permutation_for(AnemoiPermutation, cfg, state.device)(state, backend)
