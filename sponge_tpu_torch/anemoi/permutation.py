"""Batched Anemoi permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/anemoi/permutation.py``: X = state[:l] and
Y = state[l:].  ``AnemoiPermutation`` is the family module of ``family.py``
over kernel 7 (``ops/anemoi.py``) and its plain version; backends "auto",
"kernel" and "plain" as described there.
"""

from __future__ import annotations

from ..family import FamilyPermutation
from ..ops.anemoi import anemoi_permute, anemoi_permute_plain
from ..poseidon.permutation import batched_permute
from .config import AnemoiConfig, kernel_constants


class AnemoiPermutation(FamilyPermutation, config=AnemoiConfig):
    """The Anemoi permutation of one config: kernel 7 and its plain
    version."""

    kernel = staticmethod(anemoi_permute)
    plain = staticmethod(anemoi_permute_plain)
    constants = staticmethod(kernel_constants)


batched_anemoi_permute = batched_permute  # the JAX package's name
