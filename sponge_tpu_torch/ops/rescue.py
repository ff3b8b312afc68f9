"""Kernel 5: the Rescue-Prime permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_rescue.py`` (``rescue_permute_fn``):
per round x^alpha, the MDS plus rc[2r], x^(1/alpha), the MDS plus rc[2r+1];
with ``mds_first`` (Rescue Prime Optimized) each half-round's MDS and
constants before its S-box.  ``rescue_permute_plain`` computes the same
function with int64 tensor ops, canonical after every step.

The CUDA kernel has two bodies, chosen by the field (``body``): the
two-word body at Goldilocks (one 64-bit word in plain form per element,
``csrc/rescue_words.cu``: x^7 and Miden's inverse chain at alpha = 7, the
MDS rows narrow where the matrix allows; replayed by ``ops/bounds.py``
``check_rescue_gl_bounds``, which also chooses the rows) and the limb body
at every other field (24-bit Montgomery limbs, ``csrc/rescue.cu``: both
exponents through the sliding-window chain, ``rescue.config.windows``, its
odd-power table in shared memory; bounded by ``check_rescue_bounds``).  The
limb body reads ``kernel_constants``; the two-word body ``word_constants``,
a buffer of its own (``RescuePermutation.words``).  Both take the same
(t, L, B) plane of canonical Montgomery limbs.

``rescue_permute`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises: a body with no
instantiation at (t, L), or an MDS-first config at a (t, L) that
``MDS_FIRST_PAIRS`` lacks.  Its launches are counted in
``rescue_permute.launches``, and per body in ``rescue_permute.body_launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import word_body
from ..rescue.config import RescueConfig, constant_layout, schedules, unpack_constants, windows
from . import _build
from . import montgomery as mont
from .bounds import check_rescue_bounds, check_rescue_gl_bounds

# (t, L) each body is compiled for (csrc/rescue.cu's PAIR lines,
# csrc/rescue_words.cu's GL lines); the union is
# _build.INSTANTIATIONS["sponge_rescue"].
BODIES = {
    "limb": frozenset({(t, 11) for t in range(2, 10)} | {(t, 2) for t in range(9, 17)} | {(3, 2)}),
    "two-word": frozenset({(t, 3) for t in range(5, 13)}),
}
BODY_CODES = {"limb": 0, "two-word": 2}  # the C entry's ``body`` (kernel 1's codes)

# (t, L) compiled with the MDS-first order (csrc/rescue_words.cu's
# GL_MDS_FIRST lines, the two-word body): Miden's RPO256 shape, Goldilocks
# t = 12.  Rescue-Prime's order has every pair of BODIES.
MDS_FIRST_PAIRS = frozenset({(12, 3)})


def body(cfg: RescueConfig) -> str:
    """Kernel 5's body for ``cfg``: "two-word" at Goldilocks, else "limb"."""
    return "two-word" if word_body(cfg.field) else "limb"


@functools.lru_cache(maxsize=None)
def word_constants(cfg: RescueConfig) -> np.ndarray:
    """The two-word body's flat int32 constant buffer, in the order
    csrc/rescue_words.cu reads it, built once per config; empty for the limb
    body.  2^-72 mod p, 2^72 mod p, alpha and 1/alpha mod p - 1, then rc
    (2N, t) and the MDS (t, t) as plain values, each 64-bit value two
    words, low first."""
    if body(cfg) != "two-word":
        return np.zeros(0, dtype=np.int32)
    p, r = cfg.field.modulus, cfg.field.r
    values = [pow(r, -1, p), r % p, cfg.alpha, cfg.inv_alpha] + [v % p for rows in (cfg.rc, cfg.mds)
                                                                 for row in rows for v in row]
    return np.asarray(values, dtype=np.uint64).view(np.int32)


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


def _launch_args(cfg: RescueConfig, consts: torch.Tensor, words: torch.Tensor | None):
    """Kernel 5's C arguments: its body's replay, then the rounds, the limb
    body's windows and schedule lengths, the limb constants, n0inv, the
    round order, the body code, the two-word body's constants ``words``
    (``word_constants(cfg)`` on ``consts``'s device) and their length, its
    chains and its rows (``check_rescue_gl_bounds``).  A body with no
    instantiation at (t, L), or an MDS-first config at a pair without that
    order, raises: no config falls back to another body."""
    kind, pair = body(cfg), (cfg.t, cfg.field.nlimbs)
    if pair not in BODIES[kind]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 5's {kind} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[kind])}"
        )
    if cfg.mds_first and pair not in MDS_FIRST_PAIRS:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 5's MDS-first order for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(MDS_FIRST_PAIRS)}"
        )
    if kind == "limb":
        check_rescue_bounds(cfg)
        (w_alpha, w_inv), (alpha_sched, inv_sched) = windows(cfg), schedules(cfg)
        return (cfg.rounds, w_alpha, len(alpha_sched), w_inv, len(inv_sched), consts.data_ptr(), cfg.field.n0inv,
                int(cfg.mds_first), BODY_CODES[kind], None, 0, 0, 0)
    plan = check_rescue_gl_bounds(cfg)
    n = 2 * (4 + 2 * cfg.rounds * cfg.t + cfg.t ** 2)  # word_constants' length, without hashing the config
    if words is None or words.device != consts.device or words.numel() != n:
        raise ValueError(f"kernel 5's {kind} body reads word_constants(cfg) on {consts.device} "
                         f"(RescuePermutation.words); got {None if words is None else (words.device, words.numel())}")
    return (cfg.rounds, 0, 0, 0, 0, consts.data_ptr(), cfg.field.n0inv, int(cfg.mds_first), BODY_CODES[kind],
            words.data_ptr(), n, int(plan.chain), int(plan.narrow))


def rescue_permute(cfg: RescueConfig, consts: torch.Tensor, state: torch.Tensor,
                   words: torch.Tensor | None = None) -> torch.Tensor:
    """Rescue-Prime permutation of a (t, L, B) int32 canonical Montgomery
    plane.  ``consts`` is ``rescue.config.kernel_constants(cfg)`` on the
    state's device; ``words`` is ``word_constants(cfg)`` there, which the
    two-word body needs on a CUDA tensor (``RescuePermutation`` holds both
    as buffers)."""
    before = rescue_permute.launches
    out = _build.run(
        rescue_permute, "sponge_rescue", cfg, consts, state, constant_layout(cfg), rescue_permute_plain,
        functools.partial(_launch_args, words=words),
    )
    if rescue_permute.launches != before:
        rescue_permute.body_launches[body(cfg)] += 1
    return out


rescue_permute.launches = 0
rescue_permute.body_launches = dict.fromkeys(BODIES, 0)
