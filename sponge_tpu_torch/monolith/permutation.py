"""Batched Monolith permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/monolith/permutation.py:208-287``.
``MonolithPermutation`` is the family module of ``family.py`` over kernel 4
(``ops/monolith.py``) and its plain version; backends "auto", "kernel" and
"plain" as described there.
"""

from __future__ import annotations

import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.monolith import monolith_permute, monolith_permute_plain
from .config import MonolithConfig, kernel_constants


class MonolithPermutation(FamilyPermutation):
    """The Monolith permutation of one config: kernel 4 and its plain
    version."""

    kernel = staticmethod(monolith_permute)
    plain = staticmethod(monolith_permute_plain)
    constants = staticmethod(kernel_constants)


def batched_monolith_permute(cfg: MonolithConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched Monolith permutation (``family``
    backends)."""
    return permutation_for(MonolithPermutation, cfg, state.device)(state, backend)
