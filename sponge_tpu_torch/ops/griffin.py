"""Kernel 6: the Griffin-pi permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_griffin.py`` (``griffin_permute_fn``):
the opening small-integer linear layer, then per round x_0^(1/alpha) by the
sliding-window chain at ``griffin.config.window``, x_1^alpha, the quadratic
gates on x_2.., the linear layer plus rc, and the post-linear reduction
where ``ops/bounds.py`` ``check_griffin_bounds`` asks for it.  The CUDA kernel is
``csrc/griffin.cu``; ``griffin_permute_plain`` computes the same function
with int64 tensor ops, canonical after every step.

``griffin_permute`` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..griffin.config import GriffinConfig, constant_layout, schedule, unpack_constants, window
from ..poseidon.config import layout_size
from . import _build
from . import montgomery as mont
from .bounds import check_griffin_bounds


def griffin_permute_plain(cfg: GriffinConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Griffin-pi permutation with int64 tensor ops (canonical in and
    out)."""
    fs, t, p = cfg.field, cfg.t, cfg.field.modulus
    c = unpack_constants(cfg, consts)
    rc, qa, qb = c["rc"].long(), c["qa"].long(), c["qb"].long()
    mat_e = torch.tensor(cfg.mat_e, dtype=torch.int64, device=state.device)
    row_max = max(sum(row) for row in cfg.mat_e)

    def linear(x):
        y = sum(mat_e[:, j, None, None] * x[j] for j in range(t))
        return mont.reduce_small(fs, y, row_max * (p - 1) + 1)

    x = linear(state.long())
    for r in range(cfg.rounds):
        y0 = mont.mont_pow(fs, x[0], cfg.inv_alpha)
        y1 = mont.mont_pow(fs, x[1], cfg.alpha)
        out = [y0, y1]
        for i in range(2, t):
            li = (i - 1) * y0 + y1 + (x[i - 1] if i >= 3 else 0)
            li = mont.reduce_small(fs, li, (i + 1) * (p - 1) + 1)
            quad = mont.mont_add(fs, mont.mont_mul(fs, li, li), mont.mont_mul(fs, li, qa[i - 2]))
            out.append(mont.mont_mul(fs, x[i], mont.mont_add(fs, quad, qb[i - 2])))
        x = mont.mont_add(fs, linear(torch.stack(out)), rc[r])
    return x.int()


def _launch_args(cfg: GriffinConfig, consts: torch.Tensor):
    """The value bound (whether to reduce after the linear layer), then
    kernel 6's own C arguments."""
    plan = check_griffin_bounds(cfg)
    return (
        cfg.rounds, cfg.alpha, window(cfg), len(schedule(cfg)), int(plan.reduce), consts.data_ptr(),
        layout_size(constant_layout(cfg)), cfg.field.n0inv,
    )


def griffin_permute(cfg: GriffinConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Griffin-pi permutation of a (t, L, B) int32 canonical Montgomery
    plane.  ``consts`` is ``griffin.config.kernel_constants(cfg)`` on the
    state's device."""
    return _build.run(
        griffin_permute, "sponge_griffin", cfg, consts, state, constant_layout(cfg),
        griffin_permute_plain, _launch_args,
    )


griffin_permute.launches = 0
