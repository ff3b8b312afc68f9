"""Batched Griffin-pi permutation over (t, L, B) limb planes.

Counterpart of ``sponge_tpu/griffin/permutation.py``.  ``GriffinPermutation``
is the family module of ``family.py`` over kernel 6 (``ops/griffin.py``) and
its plain version; backends "auto", "kernel" and "plain" as described
there.
"""

from __future__ import annotations

from ..family import FamilyPermutation
from ..ops.griffin import griffin_permute, griffin_permute_plain
from ..poseidon.permutation import batched_permute
from .config import GriffinConfig, kernel_constants


class GriffinPermutation(FamilyPermutation, config=GriffinConfig):
    """The Griffin-pi permutation of one config: kernel 6 and its plain
    version."""

    kernel = staticmethod(griffin_permute)
    plain = staticmethod(griffin_permute_plain)
    constants = staticmethod(kernel_constants)


batched_griffin_permute = batched_permute  # the JAX package's name
