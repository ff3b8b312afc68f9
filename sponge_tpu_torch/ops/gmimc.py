"""Kernel 8: the GMiMC-erf permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_gmimc.py`` (``gmimc_permute_fn``): per
round F = (x_0 + c_r)^alpha is added to the other t-1 branches and the state
rotates left.  The CUDA kernel is ``csrc/gmimc.cu``; its deferred adds are
bounded by ``ops/bounds.py`` ``check_gmimc_bounds``.
``gmimc_permute_plain`` computes the same function with int64 tensor ops,
canonical after every step.

``gmimc_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..gmimc.config import GmimcConfig, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_gmimc_bounds


def gmimc_permute_plain(cfg: GmimcConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The GMiMC-erf permutation with int64 tensor ops (canonical in and
    out)."""
    fs = cfg.field
    rc = unpack_constants(cfg, consts)["rc"].long()  # (rounds, L, 1)
    x = state.long()
    for r in range(cfg.rounds):
        f = mont.mont_pow(fs, mont.mont_add(fs, x[0], rc[r]), cfg.alpha)
        x = torch.cat([mont.mont_add(fs, x[1:], f), x[:1]])
    return x.int()


def _launch_args(cfg: GmimcConfig, consts: torch.Tensor):
    """The deferral bound, then kernel 8's own C arguments."""
    check_gmimc_bounds(cfg)
    return cfg.rounds, cfg.alpha, consts.data_ptr(), cfg.field.n0inv


def gmimc_permute(cfg: GmimcConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """GMiMC-erf permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``gmimc.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        gmimc_permute, "sponge_gmimc", cfg, consts, state, constant_layout(cfg), gmimc_permute_plain,
        _launch_args,
    )


gmimc_permute.launches = 0
