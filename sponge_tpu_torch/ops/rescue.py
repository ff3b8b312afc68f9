"""Kernel 5: the Rescue-Prime permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_rescue.py`` (``rescue_permute_fn``):
per round x^alpha, the MDS plus rc[2r], x^(1/alpha), the MDS plus rc[2r+1];
with ``mds_first`` (Rescue Prime Optimized) each half-round's MDS and
constants before its S-box.
The CUDA kernel is ``csrc/rescue.cu``: both exponents through the
sliding-window chain (``rescue.config.windows``), its odd-power table in
shared memory.  ``rescue_permute_plain`` computes the same function with
int64 tensor ops, canonical after every step.

``rescue_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises: a (t, L) that
``_build.INSTANTIATIONS`` lacks, or an MDS-first config at a (t, L) that
``MDS_FIRST_PAIRS`` lacks.
"""

from __future__ import annotations

import torch

from ..rescue.config import RescueConfig, constant_layout, schedules, unpack_constants, windows
from . import _build
from . import montgomery as mont
from .bounds import check_rescue_bounds

# (t, L) compiled with the MDS-first order (csrc/rescue.cu sponge_rescue's
# MDS_FIRST lines): Miden's RPO256 shape, Goldilocks t = 12.  Rescue-Prime's
# order has every pair of _build.INSTANTIATIONS["sponge_rescue"].
MDS_FIRST_PAIRS = frozenset({(12, 3)})


def rescue_permute_plain(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Rescue-Prime permutation with int64 tensor ops (canonical in and
    out)."""
    fs = cfg.field
    c = unpack_constants(cfg, consts)
    rc, mds = c["rc"].long(), c["mds"].long()
    x = state.long()
    for h in range(2 * cfg.rounds):
        e = cfg.inv_alpha if h % 2 else cfg.alpha
        if not cfg.mds_first:
            x = mont.mont_pow(fs, x, e)
        x = mont.mont_add(fs, mont.mont_dot(fs, mds, x), rc[h])
        if cfg.mds_first:
            x = mont.mont_pow(fs, x, e)
    return x.int()


def _launch_args(cfg: RescueConfig, consts: torch.Tensor):
    """The value bound, then kernel 5's own C arguments.  An MDS-first
    config at a pair without that order's instantiation raises: nothing
    falls back."""
    if cfg.mds_first and (cfg.t, cfg.field.nlimbs) not in MDS_FIRST_PAIRS:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 5's MDS-first order for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(MDS_FIRST_PAIRS)}"
        )
    check_rescue_bounds(cfg)
    (w_alpha, w_inv), (alpha_sched, inv_sched) = windows(cfg), schedules(cfg)
    return (cfg.rounds, w_alpha, len(alpha_sched), w_inv, len(inv_sched), consts.data_ptr(), cfg.field.n0inv,
            int(cfg.mds_first))


def rescue_permute(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Rescue-Prime permutation of a (t, L, B) int32 canonical Montgomery
    plane.  ``consts`` is ``rescue.config.kernel_constants(cfg)`` on the
    state's device."""
    return _build.run(
        rescue_permute, "sponge_rescue", cfg, consts, state, constant_layout(cfg), rescue_permute_plain,
        _launch_args,
    )


rescue_permute.launches = 0
