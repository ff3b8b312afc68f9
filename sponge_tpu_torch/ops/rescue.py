"""Kernel 5: the Rescue-Prime permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_rescue.py`` (``rescue_permute_fn``):
per round x^alpha, the MDS plus rc[2r], x^(1/alpha), the MDS plus rc[2r+1];
both exponents through the run-length ladder of ``_exponent_runs``.  The
CUDA kernel is ``csrc/rescue.cu``; ``rescue_permute_plain`` computes the same
function with int64 tensor ops, canonical after every step.

``rescue_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..rescue.config import RescueConfig, constants_size, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_rescue_bounds
from .montgomery import ladder_schedule
from .poseidon_dense import check_state


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


def rescue_permute(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Rescue-Prime permutation of a (t, L, B) int32 canonical Montgomery
    plane.  ``consts`` is ``rescue.config.kernel_constants(cfg)`` on the
    state's device."""
    check_state(cfg, consts, state, constants_size(cfg))
    if state.device.type == "cpu":
        return rescue_permute_plain(cfg, consts, state)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    _build.check_instantiated("sponge_rescue", cfg.t, cfg.field.nlimbs)
    check_rescue_bounds(cfg)
    out = torch.empty_like(state)
    if state.shape[-1]:
        _build.launch(
            "sponge_rescue", state, out, cfg.rounds, len(ladder_schedule(cfg.alpha)),
            len(ladder_schedule(cfg.inv_alpha)), consts.data_ptr(), cfg.field.n0inv,
        )
        rescue_permute.launches += 1
    return out


rescue_permute.launches = 0
