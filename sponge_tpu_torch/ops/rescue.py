"""Kernel 5: the Rescue-Prime permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_rescue.py`` (``rescue_permute_fn``):
per round x^alpha, the MDS plus rc[2r], x^(1/alpha), the MDS plus rc[2r+1].
The CUDA kernel is ``csrc/rescue.cu``: both exponents through the
sliding-window chain (``rescue.config.windows``), its odd-power table in
shared memory.  ``rescue_permute_plain`` computes the same function with
int64 tensor ops, canonical after every step.

``rescue_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..rescue.config import RescueConfig, constant_layout, schedules, unpack_constants, windows
from . import _build
from . import montgomery as mont
from .bounds import check_rescue_bounds


def rescue_permute_plain(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Rescue-Prime permutation with int64 tensor ops (canonical in and
    out)."""
    fs = cfg.field
    c = unpack_constants(cfg, consts)
    rc, mds = c["rc"].long(), c["mds"].long()
    x = state.long()
    for h in range(2 * cfg.rounds):
        x = mont.mont_pow(fs, x, cfg.inv_alpha if h % 2 else cfg.alpha)
        x = mont.mont_add(fs, mont.mont_dot(fs, mds, x), rc[h])
    return x.int()


def _launch_args(cfg: RescueConfig, consts: torch.Tensor):
    """The value bound, then kernel 5's own C arguments."""
    check_rescue_bounds(cfg)
    (w_alpha, w_inv), (alpha_sched, inv_sched) = windows(cfg), schedules(cfg)
    return cfg.rounds, w_alpha, len(alpha_sched), w_inv, len(inv_sched), consts.data_ptr(), cfg.field.n0inv


def rescue_permute(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Rescue-Prime permutation of a (t, L, B) int32 canonical Montgomery
    plane.  ``consts`` is ``rescue.config.kernel_constants(cfg)`` on the
    state's device."""
    return _build.run(
        rescue_permute, "sponge_rescue", cfg, consts, state, constant_layout(cfg), rescue_permute_plain,
        _launch_args,
    )


rescue_permute.launches = 0
