"""Kernel 1: the Poseidon permutation with sparse partial rounds, and its
plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_cios.py`` (``cios_permute_fn``, the
production kernel): full rounds as in kernel 2; partial rounds 2..R_P
through the sparse factorization of ``poseidon/optimized.py`` (row0 dot for
element 0, col0 * x0 added into elements 1..t-1), then the accumulated dense
matrix D once, as ``pallas_cios.py:1171-1228`` does.  The CUDA kernel is
``csrc/poseidon_opt.cu``; ``permute_opt_plain`` computes the same function
with tensor ops.  ``batched_permute(backend="auto")`` launches this kernel for
a CUDA tensor.

``permute_opt`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..poseidon.config import PoseidonConfig, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .poseidon_dense import _launch_args, full_round


def permute_opt_plain(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The sparse-factorized permutation with int64 tensor ops."""
    fs = cfg.field
    c = {k: v.long() for k, v in unpack_constants(cfg, consts).items()}
    half = cfg.full_rounds // 2
    x = state.long()
    for r in range(half):
        x = full_round(cfg, x, c["ark"][r], c["mds"])
    # First partial round: ark and the element-0 S-box only.
    x = mont.mont_add(fs, x, c["ark"][half])
    x = torch.cat([mont.mont_pow(fs, x[:1], cfg.alpha), x[1:]])
    for r in range(cfg.partial_rounds - 1):
        x = mont.mont_add(fs, x, c["chat"][r])
        out0 = mont.mont_dot(fs, c["row0"][r][None], x)
        rest = mont.mont_add(fs, mont.mont_mul(fs, c["col0"][r], x[:1]), x[1:])
        x = torch.cat([mont.mont_pow(fs, out0, cfg.alpha), rest])
    x = mont.mont_dot(fs, c["dense"], x)
    for r in range(half + cfg.partial_rounds, cfg.rounds):
        x = full_round(cfg, x, c["ark"][r], c["mds"])
    return x.int()


def permute_opt(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Sparse-factorized permutation of a (t, L, B) int32 canonical
    Montgomery plane.  ``consts`` is ``kernel_constants(cfg)`` on the state's
    device."""
    if cfg.partial_rounds < 2:
        raise ValueError("the sparse-factorized kernel needs >= 2 partial rounds")
    return _build.run(
        permute_opt, "sponge_poseidon_opt", cfg, consts, state, constant_layout(cfg), permute_opt_plain,
        functools.partial(_launch_args, optimized=True),
    )


permute_opt.launches = 0
