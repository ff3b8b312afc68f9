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

``absorb_permute_opt`` is one sponge step in one launch of the same kernel:
the absorbed rate rows are added into the state as the kernel loads it, and
only the rows the caller keeps are stored (``csrc/poseidon_opt.cu``
``RateIO``); ``absorb_permute_opt_plain`` is its plain version.

Both wrappers take the plain version only for a tensor on the CPU; for a
CUDA tensor they launch the kernel or raise.  Their launches are counted in
``permute_opt.launches``.
"""

from __future__ import annotations

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


def _check_partial_rounds(cfg: PoseidonConfig) -> None:
    if cfg.partial_rounds < 2:
        raise ValueError("the sparse-factorized kernel needs >= 2 partial rounds")


def _plain_launch_args(cfg: PoseidonConfig, consts: torch.Tensor):
    """The permutation's arguments, then the rate I/O of a plain
    permutation: no rows, the state read, every row stored."""
    return _launch_args(cfg, consts, optimized=True) + (None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, cfg.t)


def permute_opt(cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Sparse-factorized permutation of a (t, L, B) int32 canonical
    Montgomery plane.  ``consts`` is ``kernel_constants(cfg)`` on the state's
    device."""
    _check_partial_rounds(cfg)
    return _build.run(
        permute_opt, "sponge_poseidon_opt", cfg, consts, state, constant_layout(cfg), permute_opt_plain,
        _plain_launch_args,
    )


permute_opt.launches = 0


def absorb_permute_opt_plain(cfg: PoseidonConfig, consts: torch.Tensor, state, lo: int, rows: tuple,
                             out_rows: tuple) -> torch.Tensor:
    """``absorb_permute_opt`` with tensor ops: the rows added by
    ``mont_add``, ``permute_opt_plain``, the rows kept."""
    fs = cfg.field
    k, L, B = rows[0].shape
    x = torch.zeros((cfg.t, L, B), dtype=torch.int32, device=rows[0].device) if state is None else state
    if k:
        hi = lo + k * len(rows)
        x = torch.cat([x[:lo], mont.mont_add(fs, x[lo:hi], torch.cat(rows)).int(), x[hi:]])
    out = permute_opt_plain(cfg, consts, x)
    a, b = out_rows
    return out if (a, b) == (0, cfg.t) else out[a:b].clone()


def absorb_permute_opt(cfg: PoseidonConfig, consts: torch.Tensor, state, lo: int, rows: tuple,
                       out_rows: tuple) -> torch.Tensor:
    """One sponge step: the canonical (k, L, B) int32 views ``rows`` (one or
    two, of any strides; the second follows the first) added mod p into
    state rows ``lo ..``, the permutation, and rows ``out_rows`` = (a, b) of
    the result as a new (b - a, L, B) plane.  ``state`` is a (t, L, B)
    canonical plane, or None for a zero state, which is then read from
    nowhere.  ``consts`` is ``kernel_constants(cfg)`` on the rows' device."""
    _check_partial_rounds(cfg)
    if len(rows) not in (1, 2) or any(r.shape != rows[0].shape for r in rows) or rows[0].dim() != 3:
        raise ValueError("rows must be one or two (k, L, B) views of one shape")
    k, L, B = rows[0].shape
    device = rows[0].device
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
        _build.check_constants(consts, device, constant_layout(cfg))
    else:
        _build.check_state(cfg, consts, state, constant_layout(cfg))
        if state.shape[-1] != B or state.device != device:
            raise ValueError(f"state {tuple(state.shape)} on {state.device}, rows {tuple(rows[0].shape)} on {device}")
    if device.type == "cpu":
        return absorb_permute_opt_plain(cfg, consts, state, lo, rows, out_rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _build.check_instantiated("sponge_poseidon_opt", cfg.t, L)
    args = _launch_args(cfg, consts, optimized=True)
    out = torch.empty((b - a, L, B), dtype=torch.int32, device=device)
    if B:
        views = [(r.data_ptr(), *r.stride()) for r in rows] if k else []
        views += [(None, 0, 0, 0)] * (2 - len(views))
        (ptr0, *strides0), (ptr1, *strides1) = views
        _build.launch("sponge_poseidon_opt", state, out, *args, ptr0, ptr1, k, *strides0, *strides1, lo,
                      int(state is None), a, b, shape=(cfg.t, L, B))
        permute_opt.launches += 1
    return out
