"""``LazyPoseidonSponge``: the lazy sponge under its own name.

Counterpart of ``sponge_tpu/lazy.py``.  ``PoseidonSponge`` is lazy by
default; a flush replays the pending rows with ``transcript._replay``.  The
JAX package caches one jitted program per segment shape; eager PyTorch has
nothing to compile, so there is no segment cache here.
"""

from __future__ import annotations

from .poseidon.permutation import SpongeConfig
from .sponge import PoseidonSponge


class LazyPoseidonSponge(PoseidonSponge):
    """``PoseidonSponge`` with ``lazy=True``."""

    def __init__(self, cfg: SpongeConfig, batch_size: int = 1, backend: str = "auto", *, device):
        super().__init__(cfg, batch_size, lazy=True, backend=backend, device=device)
