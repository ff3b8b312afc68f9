"""Kernel 8: the GMiMC-erf permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_gmimc.py`` (``gmimc_permute_fn``): per
round F = (x_0 + c_r)^alpha is added to the other t-1 branches and the state
rotates left.  The CUDA kernel is ``csrc/gmimc.cu`` with two bodies, chosen
by the field (``body``): at Goldilocks the two-word body (one element in two
32-bit words, plain form, carries of the rest-branch adds kept in an excess
word; replayed by ``ops/bounds.py`` ``check_gmimc_word_bounds``, its
constants in the buffer's word section), at every other field the limb body
(24-bit Montgomery limbs, the rest-branch adds deferred uncarried, the S-box
input reduced by a quotient estimate where the replay asks for it; bounded by
``check_gmimc_bounds``).  ``gmimc_permute_plain`` computes the same function
with int64 tensor ops, canonical after every step.

``gmimc_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import word_body
from ..gmimc.config import LIMB_SECTIONS, GmimcConfig, constant_layout, unpack_constants
from ..poseidon.config import layout_size
from . import _build
from . import montgomery as mont
from .bounds import check_gmimc_bounds, check_gmimc_word_bounds

# (t, L) each body is compiled for (csrc/gmimc.cu sponge_gmimc: the limb
# body's PAIR lines, the two-word body's WORD lines); the union is
# _build.INSTANTIATIONS["sponge_gmimc"].  The limb body takes every default
# width of the ~255-bit fields, t = 2..9; the two-word body every Goldilocks
# one, t = 5..12.  The limb body's (8, 3) runs no shipped config; chip_smoke.py
# times it beside the two-word body.
BODIES = {
    "limb": frozenset({(t, 11) for t in range(2, 10)} | {(8, 3), (3, 2)}),
    "word": frozenset({(t, 3) for t in range(5, 13)}),
}


def body(cfg: GmimcConfig) -> str:
    """Kernel 8's body for ``cfg``: "word" at Goldilocks, else "limb"."""
    return "word" if word_body(cfg.field) else "limb"


def gmimc_permute_plain(cfg: GmimcConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The GMiMC-erf permutation with int64 tensor ops (canonical in and
    out)."""
    fs = cfg.field
    rc = unpack_constants(cfg, consts)["rc"].long()  # (rounds, L, 1)
    x = state.long()
    for r in range(cfg.rounds):
        f = mont.mont_pow(fs, mont.mont_add(fs, x[0], rc[r]), cfg.alpha)
        x = torch.cat([mont.mont_add(fs, x[1:], f), x[:1]])
    return x.int()


def _launch_args(cfg: GmimcConfig, consts: torch.Tensor):
    """The body's bound replay, then kernel 8's own C arguments: the body
    code, the rounds, alpha, the front reduction (the limb body's replay
    asks for it where the values could reach R without it), the constants
    the body reads and their length, n0inv.  A body with no instantiation at
    (t, L) raises: Goldilocks never falls back to the limb body."""
    kind = body(cfg)
    if kind == "word":
        check_gmimc_word_bounds(cfg)
        reduce = 0
    else:
        reduce = int(check_gmimc_bounds(cfg).reduce)
    if (cfg.t, cfg.field.nlimbs) not in BODIES[kind]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 8's {kind} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[kind])}"
        )
    layout = constant_layout(cfg)
    limb_words = layout_size(layout[:LIMB_SECTIONS])
    if kind == "limb":
        return 0, cfg.rounds, cfg.alpha, reduce, consts.data_ptr(), limb_words, cfg.field.n0inv
    words = layout_size(layout) - limb_words
    return 1, cfg.rounds, cfg.alpha, reduce, consts[limb_words:].data_ptr(), words, cfg.field.n0inv


def gmimc_permute(cfg: GmimcConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """GMiMC-erf permutation of a (t, L, B) int32 canonical Montgomery plane.
    ``consts`` is ``gmimc.config.kernel_constants(cfg)`` on the state's
    device."""
    return _build.run(
        gmimc_permute, "sponge_gmimc", cfg, consts, state, constant_layout(cfg), gmimc_permute_plain,
        _launch_args,
    )


gmimc_permute.launches = 0
