"""Kernel 2: the dense Poseidon permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_permute.py`` (``pallas_permute_fn``):
every round is ARK, x^alpha (all elements in full rounds, element 0 in
partial rounds) and the dense t x t MDS.  The CUDA kernel has three bodies,
chosen by the field (``body``): the one-word body below 2^31 (one 32-bit
Montgomery word per element at R' = 2^32, ``csrc/poseidon_dense_words.cu``;
replayed by ``ops/bounds.py`` ``check_dense_word_bounds``), the two-word
body at Goldilocks (one 64-bit word in plain form, the same file; replayed
by ``check_dense_gl_bounds``), and the limb body at every other field
(24-bit Montgomery limbs, each output row's t products summed lazily with
one REDC, ``csrc/poseidon_dense.cu``; bounded by ``check_kernel_bounds``).
The limb body reads ``kernel_constants`` (kernel 1's buffer, of which it
stages the first three sections); the word bodies read ``word_constants``,
a buffer of their own (``PoseidonPermutation.words``).
``permute_dense_plain`` computes the same function
with tensor ops.

``permute_dense`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..gmimc.config import word_body
from ..poseidon.config import PoseidonConfig, constant_layout, unpack_constants
from ..poseidon2.config import one_word
from . import _build
from . import montgomery as mont
from .bounds import check_dense_gl_bounds, check_dense_word_bounds, check_kernel_bounds

# (t, L) each body is compiled for (csrc/poseidon_dense.cu's PAIR lines,
# csrc/poseidon_dense_words.cu's WORD and GL lines); the union is
# _build.INSTANTIATIONS["sponge_poseidon_dense"].  The word bodies take every
# default width of their fields; the limb body the ~255-bit fields' and the
# 35-bit test field (3, 2).
BODIES = {
    "limb": frozenset({(t, 11) for t in range(3, 10)} | {(3, 2)}),
    "one-word": frozenset({(16, 2)}),
    "two-word": frozenset({(8, 3), (12, 3)}),
}
BODY_CODES = {"limb": 0, "one-word": 1, "two-word": 2}  # the C entry's ``body``


def body(cfg: PoseidonConfig) -> str:
    """Kernel 2's body for ``cfg``: "one-word" below 2^31, "two-word" at
    Goldilocks, else "limb"."""
    if one_word(cfg.field):
        return "one-word"
    return "two-word" if word_body(cfg.field) else "limb"


@functools.lru_cache(maxsize=None)
def word_constants(cfg: PoseidonConfig) -> np.ndarray:
    """The word bodies' flat int32 constant buffer, in the order
    csrc/poseidon_dense_words.cu reads it, built once per config; empty for
    the limb body.  One-word body: p, -p^-1 mod 2^32, 2^16 mod p, 2^48 mod
    p, floor(2^48 / p), then ARK (R, t) and the MDS (t, t) as canonical
    words at R' = 2^32.  Two-word body: 2^-72 mod p and 2^72 mod p, then ARK
    and the MDS as plain values, each 64-bit value two words, low first."""
    p, kind = cfg.field.modulus, body(cfg)
    consts = [v % p for row in cfg.ark for v in row] + [v % p for row in cfg.mds for v in row]
    if kind == "one-word":
        words = [p, -pow(p, -1, 1 << 32) % (1 << 32), (1 << 16) % p, (1 << 48) % p, (1 << 48) // p]
        words += [(v << 32) % p for v in consts]
        return np.asarray(words, dtype=np.uint32).view(np.int32)
    if kind == "two-word":
        r = cfg.field.r
        return np.asarray([pow(r, -1, p), r % p] + consts, dtype=np.uint64).view(np.int32)
    return np.zeros(0, dtype=np.int32)


def _launch_args(cfg: PoseidonConfig, consts: torch.Tensor, optimized: bool = False,
                 words: torch.Tensor | None = None):
    """Kernel 1 (``optimized``): its value bound, then the Poseidon kernels'
    common C arguments (alpha, R_F, R_P, the limb constants, n0inv).  Kernel
    2: its body's replay, then those, the body code, the word bodies'
    constants ``words`` (``word_constants(cfg)`` on ``consts``'s device) and
    their length.  A body with no instantiation at (t, L) raises: no config
    falls back to another body."""
    head = (cfg.alpha, cfg.full_rounds, cfg.partial_rounds, consts.data_ptr(), cfg.field.n0inv)
    if optimized:
        check_kernel_bounds(cfg, optimized=True)
        return head
    kind = body(cfg)
    if kind == "limb":
        check_kernel_bounds(cfg, optimized=False)
    elif kind == "one-word":
        check_dense_word_bounds(cfg)
    else:
        check_dense_gl_bounds(cfg)
    if (cfg.t, cfg.field.nlimbs) not in BODIES[kind]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 2's {kind} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[kind])}"
        )
    if kind == "limb":
        return head + (0, None, 0)
    if words is None or words.device != consts.device or words.numel() != len(word_constants(cfg)):
        raise ValueError(f"kernel 2's {kind} body reads word_constants(cfg) on {consts.device} "
                         f"(PoseidonPermutation.words); got {None if words is None else (words.device, words.numel())}")
    return head + (BODY_CODES[kind], words.data_ptr(), words.numel())


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


def permute_dense(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor,
                  words: torch.Tensor | None = None) -> torch.Tensor:
    """Dense permutation of a (t, L, B) int32 canonical Montgomery plane.

    ``consts`` is ``kernel_constants(cfg)`` on the state's device; ``words``
    is ``word_constants(cfg)`` there, which a word body needs on a CUDA
    tensor (``PoseidonPermutation`` holds both as buffers)."""
    return _build.run(
        permute_dense, "sponge_poseidon_dense", cfg, consts, state, constant_layout(cfg),
        permute_dense_plain, functools.partial(_launch_args, words=words),
    )


permute_dense.launches = 0
