"""Kernel 3: the Poseidon2 permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_p2.py`` (``p2_permute_fn``): small-int
M_E, M_I = J + diag(mu - 1).  The CUDA kernel is ``csrc/poseidon2.cu`` with
two bodies, chosen per config by ``ops/bounds.py`` ``check_p2_bounds``: the
limb body (Montgomery products only in the S-box and the diagonal when it is
not small, values kept below R by top-carry rho-folds whose counts per
round come from the replay ``p2_plan``), and for fields below 2^31 the
one-word body (one 32-bit Montgomery word per element, its constants in the
buffer's word section).

``permute_p2_plain`` computes the same function with int64 tensor ops,
canonical after every layer: each linear layer's unreduced limb sums go
through ``montgomery.reduce_small``.

``permute_p2`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..poseidon.config import layout_size
from ..poseidon2.config import LIMB_SECTIONS, Poseidon2Config, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_p2_bounds

# (t, L) each body is compiled for (csrc/poseidon2.cu sponge_poseidon2); the
# union is _build.INSTANTIATIONS["sponge_poseidon2"].
BODIES = {
    "limb": frozenset({(3, 11), (4, 11), (8, 11), (8, 3), (12, 3), (8, 2), (3, 2)}),
    "word": frozenset({(16, 2), (8, 2), (3, 2)}),
}


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


@functools.lru_cache(maxsize=None)
def _fold_table(cfg: Poseidon2Config, device: torch.device) -> torch.Tensor:
    """The limb body's fold counts (``P2Plan.folds``) as a device int32
    table, built once per config and device."""
    return torch.tensor(check_p2_bounds(cfg).folds, dtype=torch.int32, device=device).reshape(-1)


def _launch_args(cfg: Poseidon2Config, consts: torch.Tensor):
    """The body and its plan (``check_p2_bounds``), then kernel 3's own C
    arguments: the body code, the rounds, alpha, the small-diagonal flag, the
    constants the body reads and their length, the fold table (limb body)
    and n0inv."""
    plan = check_p2_bounds(cfg)
    shape = (cfg.t, cfg.field.nlimbs)
    if shape not in BODIES[plan.body]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 3's {plan.body} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[plan.body])}"
        )
    layout = constant_layout(cfg)
    limb_words = layout_size(layout[:LIMB_SECTIONS])
    if plan.body == "limb":
        body, ptr, words, table = 0, consts.data_ptr(), limb_words, _fold_table(cfg, consts.device).data_ptr()
    else:
        body, ptr, table = 2 if plan.structured else 1, consts[limb_words:].data_ptr(), None
        words = layout_size(layout) - limb_words
    return (
        body, cfg.full_rounds, cfg.partial_rounds, cfg.alpha, int(cfg.small_diag), ptr, words, table,
        cfg.field.n0inv,
    )


def permute_p2(cfg: Poseidon2Config, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``poseidon2.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        permute_p2, "sponge_poseidon2", cfg, consts, state, constant_layout(cfg), permute_p2_plain, _launch_args
    )


permute_p2.launches = 0
