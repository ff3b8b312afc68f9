"""Inputs drawn from a run's seed, in the program's element layout."""

from __future__ import annotations

import numpy as np
import torch

from .reference import planes


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed (an input set, a job's
    indices, the judge's sample)."""
    ss = np.random.SeedSequence([seed & ((1 << 64) - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def random_plane(p: int, shape: tuple, seed: int, device) -> torch.Tensor:
    """A canonical Montgomery plane of shape (..., L, N): random 24-bit
    limbs with the top limb below p's, so every value is below p; drawn on
    ``device`` in two calls."""
    gen = torch.Generator(device=device).manual_seed(seed)
    limbs = torch.randint(0, 1 << planes.LIMB_BITS, shape, generator=gen, device=device, dtype=torch.int32)
    top = limbs[..., -1, :]
    top.copy_(torch.randint(0, planes.top_limb_bound(p), top.shape, generator=gen, device=device,
                            dtype=torch.int32))
    return limbs
