"""Kernel 2: the dense Poseidon permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_permute.py`` (``pallas_permute_fn``):
every round is ARK, x^alpha (all elements in full rounds, element 0 in
partial rounds) and the dense t x t MDS, each output row's t products summed
lazily with one Montgomery reduction.  The CUDA kernel is
``csrc/poseidon_dense.cu``; ``permute_dense_plain`` computes the same
function with tensor ops.

``permute_dense`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..poseidon.config import PoseidonConfig, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_kernel_bounds


def _launch_args(cfg: PoseidonConfig, consts: torch.Tensor, optimized: bool = False):
    """The value bound of kernel 1 (``optimized``) or 2, then the Poseidon
    kernels' own C arguments (``_build.SIGNATURES``)."""
    check_kernel_bounds(cfg, optimized=optimized)
    return cfg.alpha, cfg.full_rounds, cfg.partial_rounds, consts.data_ptr(), cfg.field.n0inv


def full_round(cfg, x, ark_r, mds):
    fs = cfg.field
    x = mont.mont_pow(fs, mont.mont_add(fs, x, ark_r), cfg.alpha)
    return mont.mont_dot(fs, mds, x)


def partial_round(cfg, x, ark_r, mds):
    fs = cfg.field
    x = mont.mont_add(fs, x, ark_r)
    x = torch.cat([mont.mont_pow(fs, x[:1], cfg.alpha), x[1:]])
    return mont.mont_dot(fs, mds, x)


def permute_dense_plain(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The dense permutation with int64 tensor ops (canonical in and out)."""
    c = unpack_constants(cfg, consts)
    ark, mds = c["ark"].long(), c["mds"].long()
    half = cfg.full_rounds // 2
    x = state.long()
    for r in range(cfg.rounds):
        if r < half or r >= half + cfg.partial_rounds:
            x = full_round(cfg, x, ark[r], mds)
        else:
            x = partial_round(cfg, x, ark[r], mds)
    return x.int()


def permute_dense(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Dense permutation of a (t, L, B) int32 canonical Montgomery plane.

    ``consts`` is ``kernel_constants(cfg)`` on the state's device."""
    return _build.run(
        permute_dense, "sponge_poseidon_dense", cfg, consts, state, constant_layout(cfg),
        permute_dense_plain, _launch_args,
    )


permute_dense.launches = 0
