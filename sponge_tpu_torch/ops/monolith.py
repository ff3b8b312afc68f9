"""Kernel 4: the Monolith permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_monolith.py`` (``monolith_kernel_fn``):
an opening Concrete, then rounds of Bars, Bricks, Concrete and + rc.  The
CUDA kernel is ``csrc/monolith.cu``; its body (generic Montgomery limbs, or
one canonical word per element over a Mersenne prime), its Concrete kind
and its fold counts come from ``ops/bounds.py`` ``check_monolith_bounds``,
its Bar chunk pattern from ``chunk_pattern`` (the kernel applies chi to all
the chunks of a word at once; ``chi_word`` is that Bar in Python).
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


# Kernel 4 unrolls each site's fold loop this far (csrc/monolith.cu kMaxFolds).
MAX_FOLDS = 4

# The Bar chunk patterns kernel 4 is compiled for, by limb count
# (csrc/monolith.cu kChunksGoldilocks, kChunks31, kChunksBabyBear).
KERNEL_CHUNK_PATTERNS = {3: frozenset({0x88888888}), 2: frozenset({0x7888, 0x43888})}


def plan_code(folds) -> int:
    """The fold counts of a plan packed 2 bits a site (csrc/monolith.cu
    ``plan_code``, kernel 4's FOLDS template argument); -1 where a count
    passes 3."""
    return -1 if max(folds) > 3 else sum(f << (2 * i) for i, f in enumerate(folds))


def chunk_pattern(fs) -> int:
    """The field's Bar chunk widths (``bar_chunks``) as 4-bit digits, the
    lowest chunk first: kernel 4's compile-time Bar pattern."""
    return sum(w << (4 * i) for i, w in enumerate(bar_chunks(fs)))


def _masks(chunks, lo: int, n: int):
    """(bits of every chunk, bits of the odd-width chunks, {(width, r):
    (keep, wrap)} of every width present) for the word holding bits
    [lo, lo + n): csrc/monolith.cu chunk_mask."""
    every = odd = 0
    spans, o = [], 0
    for w in chunks:
        if lo <= o and o + w <= lo + n:
            spans.append((o - lo, w))
            every |= ((1 << w) - 1) << (o - lo)
            if w & 1:
                odd |= ((1 << w) - 1) << (o - lo)
        o += w
    rots = {}
    for w in {w for _, w in spans}:
        for rot in (1, 2, 3):
            r = rot % w
            keep = sum(((1 << w) - 1) >> r << r << off for off, k in spans if k == w)
            wrap = sum(((1 << r) - 1) << off for off, k in spans if k == w)
            rots[w, rot] = (keep, wrap)
    return every, odd, rots


def chi_word(chunks, lo: int, n: int, y):
    """``csrc/monolith.cu`` ``chi_word``: ``chunk_sbox`` on every chunk of
    ``chunks`` inside the word of bits [lo, lo + n), at once, with shifts and
    masks (each chunk rotates within itself; an odd chunk's rot-3 term is
    forced to ones).  ``y`` is an int or an integer array of such words."""
    every, odd, rots = _masks(tuple(chunks), lo, n)

    def rot(v, r):
        out = 0
        for (w, rr), (keep, wrap) in rots.items():
            if rr == r:
                k = r % w
                out = out | ((v << k) & keep) | ((v >> (w - k)) & wrap)
        return out

    z = y ^ (rot(y ^ every, 1) & rot(y, 2) & (rot(y, 3) | odd))
    return rot(z, 1)


def _launch_args(cfg: MonolithConfig, consts: torch.Tensor):
    """The plan, then kernel 4's own C arguments."""
    plan = check_monolith_bounds(cfg)
    pattern = chunk_pattern(cfg.field)
    if pattern not in KERNEL_CHUNK_PATTERNS.get(cfg.field.nlimbs, ()):
        raise NotImplementedError(
            f"no CUDA kernel instantiation of sponge_monolith for the Bar chunks {bar_chunks(cfg.field)} "
            f"at L={cfg.field.nlimbs}"
        )
    if max(plan.folds) > MAX_FOLDS:
        raise ValueError(f"Monolith kernel, {cfg.field.name}: the plan's folds {plan.folds} pass {MAX_FOLDS}")
    words = (*plan.folds, cfg.field.modulus_bit_size, plan.shift or 0)
    return (
        cfg.rounds, cfg.bars, pattern, int(plan.body == "mersenne"), int(plan.concrete == "scaled"),
        (ctypes.c_int * len(words))(*words), consts.data_ptr(), cfg.field.n0inv,
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
