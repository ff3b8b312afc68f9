"""Kernel 7: the Anemoi permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_anemoi.py`` (``anemoi_permute_fn``):
per round the rc adds, the diffusion (M_x on X and on Y rotated left by 1,
then the PHT: Y += X, X += Y), the open Flystel on every pair with the
inverse S-box over all l pairs at once; a closing diffusion; the post-PHT
reduction where ``ops/bounds.py`` ``check_anemoi_bounds`` asks for it.  The
CUDA kernel is ``csrc/anemoi.cu``: the inverse S-box through the
sliding-window chain (``anemoi.config.window``), its odd-power table in
shared memory.  ``anemoi_permute_plain`` computes the same function with
int64 tensor ops, canonical after every step.

``anemoi_permute`` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..anemoi.config import AnemoiConfig, constant_layout, schedule, unpack_constants, window
from . import _build
from . import montgomery as mont
from .bounds import check_anemoi_bounds


def anemoi_permute_plain(cfg: AnemoiConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Anemoi permutation with int64 tensor ops (canonical in and
    out)."""
    fs, lcol = cfg.field, cfg.l
    c = unpack_constants(cfg, consts)
    rc_x, rc_y, mat = c["rc_x"].long(), c["rc_y"].long(), c["mat"].long()
    g, neg_g, neg_ginv, neg_one = c["scalars"].long()

    def diffusion(x, y):
        if lcol > 1:
            x, y = mont.mont_dot(fs, mat, x), mont.mont_dot(fs, mat, torch.roll(y, -1, 0))
        y = mont.mont_add(fs, y, x)
        return mont.mont_add(fs, x, y), y

    def square(v):
        return mont.mont_mul(fs, v, v)

    x, y = state[:lcol].long(), state[lcol:].long()
    for r in range(cfg.rounds):
        x, y = diffusion(mont.mont_add(fs, x, rc_x[r]), mont.mont_add(fs, y, rc_y[r]))
        # the subtractions as products by -g and -1 plus -g^-1, as the kernel
        u = mont.mont_add(fs, mont.mont_add(fs, x, mont.mont_mul(fs, square(y), neg_g)), neg_ginv)
        y = mont.mont_add(fs, y, mont.mont_mul(fs, mont.mont_pow(fs, u, cfg.inv_alpha), neg_one))
        x = mont.mont_add(fs, u, mont.mont_mul(fs, square(y), g))
    return torch.cat(diffusion(x, y)).int()


def _launch_args(cfg: AnemoiConfig, consts: torch.Tensor):
    """The value bound (whether to reduce after the PHT), then kernel 7's own
    C arguments."""
    plan = check_anemoi_bounds(cfg)
    return (
        cfg.rounds, window(cfg), len(schedule(cfg)), int(plan.reduce), consts.data_ptr(), cfg.field.n0inv,
    )


def anemoi_permute(cfg: AnemoiConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Anemoi permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``anemoi.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        anemoi_permute, "sponge_anemoi", cfg, consts, state, constant_layout(cfg), anemoi_permute_plain,
        _launch_args,
    )


anemoi_permute.launches = 0
