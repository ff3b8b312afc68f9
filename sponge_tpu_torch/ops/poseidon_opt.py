"""Kernel 1: the Poseidon permutation with sparse partial rounds, and its
plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_cios.py`` (``cios_permute_fn``, the
production kernel): full rounds as in kernel 2; partial rounds 2..R_P
through the sparse factorization of ``poseidon/optimized.py`` (row0 dot for
element 0, col0 * x0 added into elements 1..t-1), then the accumulated dense
matrix D once, as ``pallas_cios.py:1171-1228`` does.  The CUDA kernel is
``csrc/poseidon_opt.cu``; ``permute_opt_plain`` computes the same function
with tensor ops.  ``batched_permute(backend="auto")`` launches this kernel for
a CUDA tensor at R_P >= 2.

``absorb_permute_opt`` is one sponge step in one launch of the kernel, its
one host entry: the absorbed rate rows are added into the state as the
kernel loads it, and only the rows the caller keeps are stored
(``csrc/poseidon_opt.cu`` ``RateIO``).  ``permute_opt`` is the step with no
rows, the state read and every row kept.  ``absorb_permute_opt_plain`` is
the step's plain version, built on ``permute_opt_plain``.

The CUDA kernel has two bodies, chosen by the field (``body``): the
two-word body at Goldilocks (one 64-bit word in plain form per element,
``csrc/poseidon_opt_words.cu``; replayed by ``ops/bounds.py``
``check_opt_gl_bounds``) and the limb body at every other field (24-bit
Montgomery limbs, ``csrc/poseidon_opt.cu``; bounded by
``check_kernel_bounds``).  The limb body reads ``kernel_constants``; the
two-word body ``word_constants``, a buffer of its own
(``PoseidonPermutation.opt_words``).  Both take the same (t, L, B) plane of
canonical Montgomery limbs and the same rate I/O.

The step takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  Its launches are counted in
``permute_opt.launches``, and per body in ``permute_opt.body_launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import word_body
from ..poseidon.config import PoseidonConfig, constant_layout, unpack_constants
from ..poseidon.optimized import optimized_partial_layers
from . import _build
from . import montgomery as mont
from .bounds import check_kernel_bounds, check_opt_gl_bounds
from .poseidon_dense import full_round

# (t, L) each body is compiled for (csrc/poseidon_opt.cu's PAIR lines,
# csrc/poseidon_opt_words.cu's GL lines); the union is
# _build.INSTANTIATIONS["sponge_poseidon_opt"].
BODIES = {
    "limb": frozenset({(t, 11) for t in range(3, 10)} | {(16, 2), (3, 2)}),
    "two-word": frozenset({(8, 3), (12, 3)}),
}
BODY_CODES = {"limb": 0, "two-word": 2}  # the C entry's ``body`` (kernel 2's codes)


def body(cfg: PoseidonConfig) -> str:
    """Kernel 1's body for ``cfg``: "two-word" at Goldilocks, else "limb"."""
    return "two-word" if word_body(cfg.field) else "limb"


@functools.lru_cache(maxsize=None)
def word_constants(cfg: PoseidonConfig) -> np.ndarray:
    """The two-word body's flat int32 constant buffer, in the order
    csrc/poseidon_opt_words.cu reads it, built once per config; empty for
    the limb body and for a config kernel 1 does not run (R_P < 2).
    2^-72 mod p and 2^72 mod p, then ARK (R, t), the MDS (t, t) and the
    sparse factorization, c^ (R_P - 1, t), row0 (R_P - 1, t), col0
    (R_P - 1, t - 1) and D (t, t), as plain values (``constant_layout``'s
    sections after p), each 64-bit value two words, low first."""
    if body(cfg) != "two-word" or cfg.partial_rounds < 2:
        return np.zeros(0, dtype=np.int32)
    p, r = cfg.field.modulus, cfg.field.r
    layers = optimized_partial_layers(cfg)
    sections = (cfg.ark, cfg.mds, layers.constants, [sp.row0 for sp in layers.sparse],
                [sp.col0 for sp in layers.sparse], layers.dense)
    values = [pow(r, -1, p), r % p] + [v % p for rows in sections for row in rows for v in row]
    return np.asarray(values, dtype=np.uint64).view(np.int32)


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


def _launch_args(cfg: PoseidonConfig, consts: torch.Tensor, words: torch.Tensor | None):
    """Kernel 1's C arguments before its rate I/O: its body's replay, then
    the Poseidon kernels' common head (alpha, R_F, R_P, the limb constants,
    n0inv), the body code, the two-word body's constants ``words``
    (``word_constants(cfg)`` on ``consts``'s device) and their length.  A
    body with no instantiation at (t, L) raises: no config falls back to
    another body."""
    kind = body(cfg)
    if kind == "limb":
        check_kernel_bounds(cfg, optimized=True)
    else:
        check_opt_gl_bounds(cfg)
    if (cfg.t, cfg.field.nlimbs) not in BODIES[kind]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 1's {kind} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[kind])}"
        )
    head = (cfg.alpha, cfg.full_rounds, cfg.partial_rounds, consts.data_ptr(), cfg.field.n0inv)
    if kind == "limb":
        return head + (BODY_CODES[kind], None, 0)
    t, k = cfg.t, cfg.partial_rounds - 1  # word_constants' length, without hashing the config
    if words is None or words.device != consts.device or words.numel() != 2 * (
            2 + cfg.rounds * t + 2 * t * t + k * (3 * t - 1)):
        raise ValueError(f"kernel 1's {kind} body reads word_constants(cfg) on {consts.device} "
                         f"(PoseidonPermutation.opt_words); got {None if words is None else (words.device, words.numel())}")
    return head + (BODY_CODES[kind], words.data_ptr(), words.numel())


def permute_opt(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor,
                words: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse-factorized permutation of a (t, L, B) int32 canonical
    Montgomery plane: ``absorb_permute_opt`` with no rows, the state read
    and every row kept.  ``consts`` is ``kernel_constants(cfg)`` on the
    state's device; ``words`` is ``word_constants(cfg)`` there, which the
    two-word body needs on a CUDA tensor (``PoseidonPermutation`` holds
    both as buffers)."""
    return absorb_permute_opt(cfg, consts, state, 0, (), (0, cfg.t), words)


permute_opt.launches = 0
permute_opt.body_launches = dict.fromkeys(BODIES, 0)


def absorb_permute_opt_plain(cfg: PoseidonConfig, consts: torch.Tensor, state, lo: int, rows: tuple,
                             out_rows: tuple) -> torch.Tensor:
    """``absorb_permute_opt`` with tensor ops: the rows added by
    ``mont_add``, ``permute_opt_plain``, the rows kept."""
    fs = cfg.field
    if state is None:
        state = torch.zeros((cfg.t, fs.nlimbs, rows[0].shape[-1]), dtype=torch.int32, device=rows[0].device)
    if rows and rows[0].shape[0]:
        hi = lo + rows[0].shape[0] * len(rows)
        state = torch.cat([state[:lo], mont.mont_add(fs, state[lo:hi], torch.cat(rows)).int(), state[hi:]])
    out = permute_opt_plain(cfg, consts, state)
    a, b = out_rows
    return out if (a, b) == (0, cfg.t) else out[a:b].clone()


def absorb_permute_opt(cfg: PoseidonConfig, consts: torch.Tensor, state, lo: int, rows: tuple,
                       out_rows: tuple, words: torch.Tensor | None = None) -> torch.Tensor:
    """One sponge step: the canonical (k, L, B) int32 views ``rows`` (none,
    one or two, of any strides; the second follows the first) added mod p
    into state rows ``lo ..``, the permutation, and rows ``out_rows`` =
    (a, b) of the result as a new (b - a, L, B) plane.  ``state`` is a
    (t, L, B) canonical plane, or None for a zero state, which is then read
    from nowhere (the rows give its lanes).  ``consts`` is
    ``kernel_constants(cfg)`` on the data's device, ``words``
    ``word_constants(cfg)`` there (the two-word body's, needed on a CUDA
    tensor)."""
    if cfg.partial_rounds < 2:
        raise ValueError("the sparse-factorized kernel needs >= 2 partial rounds")
    layout = constant_layout(cfg)
    if state is not None:
        _build.check_state(cfg, consts, state, layout)
    elif not rows:
        raise ValueError("a zero state needs rows to give its lanes")
    if len(rows) > 2 or any(r.dim() != 3 or r.shape != rows[0].shape for r in rows):
        raise ValueError("rows must be none, one or two (k, L, B) views of one shape")
    k, L, B = rows[0].shape if rows else (0, *state.shape[1:])
    device = rows[0].device if rows else state.device
    if L != cfg.field.nlimbs:
        raise ValueError(f"rows must have L = {cfg.field.nlimbs} limbs, got {L}")
    if any(r.dtype != torch.int32 for r in rows):
        raise TypeError("rows must be int32")
    if any(r.device != device for r in rows):
        raise ValueError("rows on different devices")
    if lo < 0 or lo + k * len(rows) > cfg.t:
        raise ValueError(f"{k * len(rows)} rows from state row {lo} pass t = {cfg.t}")
    a, b = out_rows
    if not 0 <= a < b <= cfg.t:
        raise ValueError(f"output rows [{a}, {b}) outside [0, {cfg.t})")
    if state is None:
        _build.check_constants(consts, device, layout)
    elif state.shape[-1] != B or state.device != device:
        raise ValueError(f"state {tuple(state.shape)} on {state.device}, rows {tuple(rows[0].shape)} on {device}")
    if device.type == "cpu":
        return absorb_permute_opt_plain(cfg, consts, state, lo, rows, out_rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return _launch(cfg, consts, words, state, lo, rows, out_rows, B)


def _launch(cfg: PoseidonConfig, consts: torch.Tensor, words, state, lo: int, rows: tuple, out_rows: tuple,
            B: int) -> torch.Tensor:
    """A checked step's launch: its body's bounds and (t, L) instantiation
    and its arguments (``_launch_args``), the output plane, one launch of
    ``B`` lanes, counted in ``permute_opt.launches`` and its body's count."""
    args = _launch_args(cfg, consts, words)
    a, b = out_rows
    L = cfg.field.nlimbs
    out = torch.empty((b - a, L, B), dtype=torch.int32, device=consts.device)
    if B:
        k = rows[0].shape[0] if rows else 0
        views = [(r.data_ptr(), *r.stride()) for r in rows] if k else []
        views += [(None, 0, 0, 0)] * (2 - len(views))
        (ptr0, *strides0), (ptr1, *strides1) = views
        _build.launch("sponge_poseidon_opt", state, out, *args, ptr0, ptr1, k, *strides0, *strides1, lo,
                      int(state is None), a, b, shape=(cfg.t, L, B))
        permute_opt.launches += 1
        permute_opt.body_launches[body(cfg)] += 1
    return out
