"""Kernel 3: the Poseidon2 permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_p2.py`` (``p2_permute_fn``): small-int
M_E, M_I = J + diag(mu - 1), Montgomery products only in the S-box (and the
diagonal when it is not small), values kept below R by top-carry rho-folds
at static sites.  The CUDA kernel is ``csrc/poseidon2.cu``; its fold counts
come from the static schedule replay ``ops/bounds.py`` ``p2_plan``.

``permute_p2_plain`` computes the same function with int64 tensor ops,
canonical after every layer: each linear layer's unreduced limb sums go
through ``montgomery.reduce_small``.

``permute_p2`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..poseidon2.config import Poseidon2Config, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import p2_plan
from .montgomery import ladder_schedule


def _small_mat(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def permute_p2_plain(cfg: Poseidon2Config, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Poseidon2 permutation with int64 tensor ops (canonical in and out)."""
    fs, t, p = cfg.field, cfg.t, cfg.field.modulus
    c = unpack_constants(cfg, consts)
    ext, internal, diag_mont = c["ext"].long(), c["int"].long(), c["diag_mont"].long()
    mat_e = _small_mat(cfg.mat_e, state.device)
    dm1 = cfg.diag_m1
    row_max = max(sum(row) for row in cfg.mat_e)
    half = cfg.full_rounds // 2

    def external(x):
        y = sum(mat_e[:, j, None, None] * x[j] for j in range(t))
        return mont.reduce_small(fs, y, row_max * (p - 1) + 1)

    def external_round(x, r):
        return external(mont.mont_pow(fs, mont.mont_add(fs, x, ext[r]), cfg.alpha))

    x = external(state.long())
    for r in range(half):
        x = external_round(x, r)
    for r in range(cfg.partial_rounds):
        x0 = mont.mont_pow(fs, mont.mont_add(fs, x[:1], internal[r]), cfg.alpha)
        x = torch.cat([x0, x[1:]])
        sigma = x.sum(0)
        if cfg.small_diag:
            y = sigma + _small_mat(dm1, state.device)[:, None, None] * x
            x = mont.reduce_small(fs, y, (t + max(dm1)) * (p - 1) + 1)
        else:
            x = mont.reduce_small(fs, sigma + mont.mont_mul(fs, x, diag_mont), (t + 1) * (p - 1) + 1)
    for r in range(half, cfg.full_rounds):
        x = external_round(x, r)
    return x.int()


def _launch_args(cfg: Poseidon2Config, consts: torch.Tensor):
    """The fold plan, then kernel 3's own C arguments."""
    plan = p2_plan(cfg)
    folds = (ctypes.c_int * len(plan.folds))(*plan.folds)
    return (
        cfg.full_rounds, cfg.partial_rounds, len(ladder_schedule(cfg.alpha)), int(cfg.small_diag), folds,
        consts.data_ptr(), cfg.field.n0inv,
    )


def permute_p2(cfg: Poseidon2Config, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``poseidon2.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        permute_p2, "sponge_poseidon2", cfg, consts, state, constant_layout(cfg), permute_p2_plain, _launch_args
    )


permute_p2.launches = 0
