"""Kernel 4: the Monolith permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_monolith.py`` (``monolith_kernel_fn``):
an opening Concrete, then rounds of Bars, Bricks, Concrete and + rc.  The
CUDA kernel is ``csrc/monolith.cu``; its body (generic Montgomery limbs, or
one canonical word per element over a Mersenne prime), its Concrete kind
and its fold counts come from ``ops/bounds.py`` ``check_monolith_bounds``.
``monolith_permute_plain`` computes the same function with int64 tensor
ops, canonical after every layer, in Montgomery form for every field.

``monolith_permute`` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import LIMB_BITS
from ..monolith.config import MonolithConfig, bar_chunks, chunk_sbox, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_monolith_bounds


def bar_plane(fs, plain: torch.Tensor) -> torch.Tensor:
    """Bar of (..., L, B) canonical plain limbs: each chunk lies inside one
    24-bit limb (``bar_chunks``), passes ``chunk_sbox`` and goes back in
    place."""
    rows = list(plain.long().unbind(-2))
    out = [torch.zeros_like(r) for r in rows]
    bit = 0
    for w in bar_chunks(fs):
        k, off = divmod(bit, LIMB_BITS)
        out[k] = out[k] | (chunk_sbox((rows[k] >> off) & ((1 << w) - 1), w) << off)
        bit += w
    return torch.stack(out, -2)


def monolith_permute_plain(cfg: MonolithConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Monolith permutation with int64 tensor ops (canonical Montgomery
    in and out).  The constant buffer's round constants and dense matrix are
    taken to Montgomery form where the Mersenne body keeps them plain."""
    fs, t, p = cfg.field, cfg.t, cfg.field.modulus
    plan = check_monolith_bounds(cfg)
    c = unpack_constants(cfg, consts)
    rc, mat = c["rc"].long(), c["mat"].long()
    if plan.body == "mersenne":
        rc = mont.to_mont(fs, rc)
        if plan.concrete == "dense":
            mat = mont.to_mont(fs, mat)
    row_max = max(sum(row) for row in cfg.concrete)

    def concrete(x):
        if plan.concrete == "dense":
            return mont.mont_dot(fs, mat, x)
        y = sum(mat[:, j, :1] * x[j] for j in range(t))  # plain entries: limb 0 of each
        return mont.reduce_small(fs, y, row_max * (p - 1) + 1)

    u = cfg.bars
    x = concrete(state.long())
    for r in range(cfg.rounds):
        barred = mont.to_mont(fs, bar_plane(fs, mont.from_mont(fs, x[:u])))
        x = torch.cat([barred, x[u:]])
        x = torch.cat([x[:1], mont.mont_add(fs, x[1:], mont.mont_mul(fs, x[:-1], x[:-1]))])
        x = mont.mont_add(fs, concrete(x), rc[r])
    return x.int()


def _launch_args(cfg: MonolithConfig, consts: torch.Tensor):
    """The plan, then kernel 4's own C arguments."""
    plan = check_monolith_bounds(cfg)
    words = (*plan.folds, cfg.field.modulus_bit_size, plan.shift or 0)
    return (
        cfg.rounds, cfg.bars, len(bar_chunks(cfg.field)), int(plan.body == "mersenne"),
        int(plan.concrete == "scaled"), (ctypes.c_int * len(words))(*words), consts.data_ptr(),
        cfg.field.n0inv,
    )


def monolith_permute(cfg: MonolithConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Monolith permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``monolith.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        monolith_permute, "sponge_monolith", cfg, consts, state, constant_layout(cfg), monolith_permute_plain,
        _launch_args,
    )


monolith_permute.launches = 0
