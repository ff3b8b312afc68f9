"""Batched Poseidon permutation over (t, L, B) limb planes, and the
permutation dispatch of every family.

Counterpart of ``sponge_tpu/poseidon/permutation.py``.  The state of B
independent sponges is a ``(t, L, B)`` int32 plane of canonical Montgomery
limbs; a permutation maps it to a new plane of the same shape.

``PoseidonPermutation`` is an ``nn.Module`` whose constant buffers (round
constants, MDS, sparse factorization: ``kernel_constants``; kernel 2's word
bodies' own: ``ops/poseidon_dense.py`` ``word_constants``; kernel 1's
two-word body's own: ``ops/poseidon_opt.py`` ``word_constants``) are
registered buffers, so ``.to("cuda")`` moves them.  ``batched_permute`` keeps one module
per (config, device).  Backends:

* ``"auto"``: the sparse-factorized kernel (``ops/poseidon_opt.py``) for a
  CUDA tensor, its plain version for a CPU tensor;
* ``"opt"`` / ``"dense"``: that CUDA kernel; a CPU tensor raises;
* ``"plain"``: the dense plain PyTorch permutation (``permute``), on any
  device.

``absorb_permute`` is one sponge step: rate rows added into a state (or a
fresh zero sponge), the permutation, the rows the caller keeps.  Where
``batched_permute`` would run kernel 1 it is one launch of kernel 1
(``ops/poseidon_opt.py`` ``absorb_permute_opt``; on the CPU its plain
version); elsewhere ``add_rows``, ``batched_permute`` and a slice.
``overwrite_rows`` is the overwrite mode's write of a chunk into a state.
"""

from __future__ import annotations

import functools
from typing import Protocol

import torch
from torch import nn

from ..fields import FieldSpec
from ..ops.poseidon_dense import permute_dense, permute_dense_plain, word_constants
from ..ops import montgomery as mont
from ..ops import poseidon_opt
from ..ops.poseidon_opt import absorb_permute_opt, permute_opt
from ..utils.profiling import ABSORB, ABSORB_FUSED, OVERWRITE, PERMUTE, annotate
from .config import PoseidonConfig, kernel_constants

BACKENDS = ("auto", "opt", "dense", "plain")


class SpongeConfig(Protocol):
    """What the sponge, transcript and hash layers read of a config: a
    ``PoseidonConfig``, or any family's config with a ``batched_permute``
    hook (``Poseidon2Config``, ``RescueConfig``, ``GmimcConfig``,
    ``GriffinConfig``, ``AnemoiConfig``)."""

    field: FieldSpec
    rate: int
    capacity: int

    @property
    def t(self) -> int: ...


class PoseidonPermutation(nn.Module):
    """The Poseidon permutation of one config as a module (no parameters,
    no gradient: int32 constant buffers, ``consts`` for every backend,
    ``words`` for kernel 2's word bodies and ``opt_words`` for kernel 1's
    two-word body, each empty where its body does not run)."""

    def __init__(self, cfg: PoseidonConfig, device):
        super().__init__()
        self.cfg = cfg
        consts = torch.from_numpy(kernel_constants(cfg))
        self.register_buffer("consts", consts.to(device), persistent=False)
        self.register_buffer("words", torch.from_numpy(word_constants(cfg)).to(device), persistent=False)
        self.register_buffer("opt_words", torch.from_numpy(poseidon_opt.word_constants(cfg)).to(device),
                             persistent=False)

    @torch.no_grad()
    def forward(self, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        if backend == "plain":
            return permute_dense_plain(self.cfg, self.consts, state)
        if backend in ("opt", "dense") and state.device.type != "cuda":
            raise ValueError(
                f"backend={backend!r} runs a CUDA kernel; the state is on {state.device}"
            )
        if backend == "dense" or (backend == "auto" and self.cfg.partial_rounds < 2):
            return permute_dense(self.cfg, self.consts, state, self.words)
        if backend in ("auto", "opt"):
            return permute_opt(self.cfg, self.consts, state, self.opt_words)
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


@functools.lru_cache(maxsize=None)
def permutation_for(cfg: PoseidonConfig, device: torch.device) -> PoseidonPermutation:
    """The cached permutation module of ``cfg`` with its buffer on ``device``."""
    return PoseidonPermutation(cfg, device)


def batched_permute(cfg: SpongeConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched permutation (see module docstring).  Any
    other config of the port (Poseidon2, Rescue-Prime, GMiMC, Griffin,
    Anemoi) goes to its family's hook, ``cfg.batched_permute(state,
    backend)``, with backends "auto", "kernel" and "plain".  Each call is
    one ``sponge.permute`` span (``utils.profiling``), its count the lanes."""
    if not isinstance(getattr(cfg, "field", None), FieldSpec):
        raise NotImplementedError(f"{type(cfg).__name__}: not a config of the PyTorch port")
    with annotate(PERMUTE, state.shape[-1]):
        if isinstance(cfg, PoseidonConfig):
            return permutation_for(cfg, state.device)(state, backend)
        return cfg.batched_permute(state, backend)


def add_rows(cfg: SpongeConfig, state: torch.Tensor, start: int, chunk: torch.Tensor):
    """``state[capacity+start : +k] += chunk`` as a NEW tensor: sponges share
    planes between clones, so a plane is never written in place.  One
    ``sponge.absorb`` span (``utils.profiling``), its count the lanes."""
    with annotate(ABSORB, chunk.shape[-1]):
        lo = cfg.capacity + start
        hi = lo + chunk.shape[0]
        rows = mont.mont_add(cfg.field, state[lo:hi], chunk).int()
        return torch.cat([state[:lo], rows, state[hi:]])


def overwrite_rows(cfg: SpongeConfig, state: torch.Tensor, chunk: torch.Tensor):
    """``state[:k] = chunk`` as a NEW tensor, as ``add_rows`` writes: the
    overwrite mode of Plonky3's sponges, whose rate sits in front of the
    capacity.  One ``sponge.overwrite`` span (``utils.profiling``), its
    count the lanes."""
    k = chunk.shape[0]
    if k > cfg.rate:
        raise ValueError(f"{k} rows pass the rate {cfg.rate}")
    with annotate(OVERWRITE, chunk.shape[-1]):
        return torch.cat([chunk, state[k:]])


def absorb_permute(
    cfg: SpongeConfig, state, start: int, rows: torch.Tensor, rows2=None, out_rows=None, backend: str = "auto"
) -> torch.Tensor:
    """One sponge step: the canonical (k, L, B) planes ``rows`` and then
    ``rows2`` (views of any strides) added into the rate of ``state`` from
    rate position ``start`` (``state`` None: a fresh zero sponge), the
    permutation, and the permuted state's rows ``out_rows`` = (lo, hi) as a
    new (hi - lo, L, B) plane (all t rows by default).  Where
    ``batched_permute`` would launch kernel 1 (a ``PoseidonConfig`` with
    R_P >= 2, backend "auto", or "opt" on a CUDA tensor) the step is one
    launch of it, or its plain version on the CPU: a ``sponge.absorb_fused``
    span around a ``sponge.permute`` span, both counting the lanes.  Every
    other config, backend or device runs ``add_rows`` (of the two planes'
    ``cat``), ``batched_permute`` and a copy of the rows kept, as a sponge
    does."""
    views = (rows,) if rows2 is None else (rows, rows2)
    k = sum(v.shape[0] for v in views)
    if start < 0 or start + k > cfg.rate:
        raise ValueError(f"{k} rows from rate position {start} pass the rate {cfg.rate}")
    lanes = rows.shape[-1]
    if (isinstance(cfg, PoseidonConfig) and cfg.partial_rounds >= 2
            and (backend == "auto" or (backend == "opt" and rows.device.type == "cuda"))):
        with annotate(ABSORB_FUSED, lanes), annotate(PERMUTE, lanes):
            perm = permutation_for(cfg, rows.device)
            return absorb_permute_opt(cfg, perm.consts, state, cfg.capacity + start, views,
                                      (0, cfg.t) if out_rows is None else out_rows, perm.opt_words)
    if state is None:
        state = zero_state(cfg, lanes, rows.device)
    if k:
        state = add_rows(cfg, state, start, rows if rows2 is None else torch.cat(views))
    state = batched_permute(cfg, state, backend)
    return state if out_rows is None else state[out_rows[0] : out_rows[1]].clone()


def permute(cfg: SpongeConfig, state: torch.Tensor) -> torch.Tensor:
    """The plain permutation (the JAX package's ``permute`` tier)."""
    return batched_permute(cfg, state, "plain")


def zero_state(cfg: SpongeConfig, batch: int, device) -> torch.Tensor:
    """Zero-initialized sponge states; zero is 0 in Montgomery form."""
    return torch.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=torch.int32, device=device)
