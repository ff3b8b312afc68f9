"""Batched Rescue-Prime permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/rescue/permutation.py``.  ``RescuePermutation``
is the family module of ``family.py`` over kernel 5 (``ops/rescue.py``) and
its plain version; backends "auto", "kernel" and "plain" as described there.
"""

from __future__ import annotations

import functools

import torch

from ..family import FamilyPermutation, permutation_for
from ..ops.rescue import rescue_permute, rescue_permute_plain
from ..poseidon.config import mont_limb_rows
from .config import RescueConfig, kernel_constants


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: RescueConfig):
    """``(rc, mds)`` in the JAX package's device layout (numpy) with the
    port's 24-bit Montgomery limbs: rc (2N, t, L, 1), mds (t, t, L, 1)."""
    fs = cfg.field
    return mont_limb_rows(fs, cfg.rc)[..., None], mont_limb_rows(fs, cfg.mds)[..., None]


class RescuePermutation(FamilyPermutation):
    """The Rescue-Prime permutation of one config: kernel 5 and its plain
    version."""

    kernel = staticmethod(rescue_permute)
    plain = staticmethod(rescue_permute_plain)
    constants = staticmethod(kernel_constants)


def batched_rescue_permute(cfg: RescueConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched Rescue-Prime permutation (``family``
    backends)."""
    return permutation_for(RescuePermutation, cfg, state.device)(state, backend)
