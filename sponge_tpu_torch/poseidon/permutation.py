"""Batched Poseidon permutation over (t, L, B) limb planes, and the
permutation dispatch of every family.

Counterpart of ``sponge_tpu/poseidon/permutation.py``.  The state of B
independent sponges is a ``(t, L, B)`` int32 plane of canonical Montgomery
limbs; a permutation maps it to a new plane of the same shape.

``PoseidonPermutation`` is Poseidon's ``family.FamilyPermutation``: its
constant buffers (round constants, MDS, sparse factorization:
``kernel_constants``; kernel 2's word bodies' own: ``ops/poseidon_dense.py``
``word_constants``; kernel 1's two-word body's own: ``ops/poseidon_opt.py``
``word_constants``) are registered buffers, so ``.to("cuda")`` moves them.
Its kernel is chosen from the config: the sparse-factorized kernel 1
(``ops/poseidon_opt.py``) at R_P >= 2, which also has the one-launch
sponge step, else the dense kernel 2 (``ops/poseidon_dense.py``); its plain
version is the dense plain permutation.  Backends are ``family``'s.

``batched_permute`` runs any config of the port through
``family.permutation_for``.  ``absorb_permute`` is one sponge step: rate
rows added into a state (or a fresh sponge, zero or with its capacity set
from a domain tag), the permutation, the rows the caller keeps; one launch
where the module has a step (a tag folded into the first round's
constants, ``PoseidonPermutation.tagged``), elsewhere ``add_rows``, the
permutation and a slice.  ``overwrite_rows`` is the overwrite mode's write
of a chunk into a state; ``overwrite_permute`` the whole overwrite sponge
in one launch, where the module has it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Protocol

import torch

from ..family import FamilyPermutation, check_backend, permutation_for
from ..fields import FieldSpec
from ..ops.poseidon_dense import permute_dense, permute_dense_plain, word_constants
from ..ops import montgomery as mont
from ..ops import poseidon_opt
from ..ops.poseidon_opt import absorb_permute_opt, permute_opt
from ..utils.profiling import ABSORB, ABSORB_FUSED, OVERWRITE, OVERWRITE_FUSED, PERMUTE, annotate
from .config import PoseidonConfig, kernel_constants


class SpongeConfig(Protocol):
    """What the sponge, transcript and hash layers read of a config: a
    config of any family of the port (``family.MODULES``)."""

    field: FieldSpec
    rate: int
    capacity: int

    @property
    def t(self) -> int: ...


class PoseidonPermutation(FamilyPermutation, config=PoseidonConfig):
    """The Poseidon permutation of one config: ``consts`` for every
    backend, ``words`` for kernel 2's word bodies and ``opt_words`` for
    kernel 1's two-word body, each empty where its body does not run."""

    plain = staticmethod(permute_dense_plain)
    constants = staticmethod(kernel_constants)
    extra = {"words": word_constants, "opt_words": poseidon_opt.word_constants}

    def __init__(self, cfg: PoseidonConfig, device):
        super().__init__(cfg, device)
        self.fused = cfg.partial_rounds >= 2
        self._tagged = {}

    def kernel(self, cfg: PoseidonConfig, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return permute_opt(cfg, consts, state, self.opt_words)
        return permute_dense(cfg, consts, state, self.words)

    def step(self, state, lo: int, rows: tuple, out_rows: tuple, tag: tuple | None = None) -> torch.Tensor:
        """Kernel 1's sponge step (``absorb_permute_opt``); a fresh state
        whose capacity starts from ``tag`` runs on ``tagged(tag)``'s
        constants."""
        perm = self if tag is None else self.tagged(tag)
        return absorb_permute_opt(perm.cfg, perm.consts, state, lo, rows, out_rows, perm.opt_words)

    def tagged(self, tag: tuple) -> "PoseidonPermutation":
        """The permutation with the canonical capacity values ``tag`` folded
        into its first round's constants: a fresh state's first operation
        is that round's ARK, so P(x + tag) = P'(x), and a state whose
        capacity is zero (kernel 1's fresh load) gives on P' what the
        tagged state gives on P, with no change to the kernel or its
        launch.  Only ARK row 0's first ``len(tag)`` entries differ from
        this module's constants.  Built once per tag, on this module's
        device."""
        perm = self._tagged.get(tag)
        if perm is None:
            cfg, p = self.cfg, self.cfg.field.modulus
            first = tuple((c + v) % p for c, v in zip(cfg.ark[0], tag + (0,) * (cfg.t - len(tag))))
            tagged = dataclasses.replace(cfg, ark=(first, *cfg.ark[1:]))
            perm = self._tagged[tag] = PoseidonPermutation(tagged, self.consts.device)
        return perm


def batched_permute(cfg: SpongeConfig, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched batched permutation of any family's config (see
    ``family``).  Each call is one ``sponge.permute`` span
    (``utils.profiling``), its count the lanes."""
    with annotate(PERMUTE, state.shape[-1]):
        return permutation_for(cfg, state.device)(state, backend)


def add_rows(cfg: SpongeConfig, state: torch.Tensor, start: int, chunk: torch.Tensor):
    """``state[capacity+start : +k] += chunk`` as a NEW tensor: sponges share
    planes between clones, so a plane is never written in place.  One
    ``sponge.absorb`` span (``utils.profiling``), its count the lanes."""
    with annotate(ABSORB, chunk.shape[-1]):
        lo = cfg.capacity + start
        hi = lo + chunk.shape[0]
        rows = mont.mont_add(cfg.field, state[lo:hi], chunk).int()
        return torch.cat([state[:lo], rows, state[hi:]])


def overwrite_rows(cfg: SpongeConfig, state: torch.Tensor, chunk: torch.Tensor, lo: int = 0):
    """``state[lo : lo + k] = chunk`` as a NEW tensor, as ``add_rows``
    writes: the overwrite mode of Plonky3's sponges, whose rate sits in
    front of the capacity (``lo`` 0), or of Miden's, whose rate follows it
    (``lo`` the capacity).  One ``sponge.overwrite`` span
    (``utils.profiling``), its count the lanes."""
    k = chunk.shape[0]
    if k > cfg.rate:
        raise ValueError(f"{k} rows pass the rate {cfg.rate}")
    if not 0 <= lo <= cfg.t - k:
        raise ValueError(f"{k} rows from row {lo} pass the width {cfg.t}")
    with annotate(OVERWRITE, chunk.shape[-1]):
        return torch.cat([state[:lo], chunk, state[lo + k :]])


def overwrite_permute(cfg: SpongeConfig, views: tuple, width: int, out_rows: int, backend: str = "auto"):
    """Plonky3's overwrite sponge in one launch, where the config's module
    has it (``overwrites``: kernel 3's one-word body) and the backend is not
    "plain": from a zero state, the canonical (k, L, B) ``views`` (one or
    two, of any strides) written ``width`` rows at a time over the state's
    first rows, each chunk followed by the permutation, then rows
    [0, ``out_rows``) as a new plane; on the CPU under "auto" its plain
    version ("kernel" refuses a CPU tensor).  A ``sponge.overwrite_fused``
    span around a ``sponge.permute`` span, both counting the permutations,
    lanes times chunks.  None for every other config or backend: the
    caller then runs ``overwrite_rows`` (or its own ``cat``) and the
    permutation itself."""
    device = views[0].device
    perm = permutation_for(cfg, device)
    if not perm.overwrites or backend == "plain":
        return None
    check_backend(backend, device)
    chunks = views[0].shape[-1] * -(-sum(v.shape[0] for v in views) // width)
    with annotate(OVERWRITE_FUSED, chunks), annotate(PERMUTE, chunks):
        return perm.overwrite(views, width, out_rows)


def absorb_permute(
    cfg: SpongeConfig, state, start: int, rows: torch.Tensor, rows2=None, out_rows=None, backend: str = "auto",
    tag=None,
) -> torch.Tensor:
    """One sponge step: the canonical (k, L, B) planes ``rows`` and then
    ``rows2`` (views of any strides) added into the rate of ``state`` from
    rate position ``start`` (``state`` None: a fresh sponge, whose capacity
    rows are zero, or the canonical values ``tag`` where given: a domain
    tag), the permutation, and the permuted state's rows ``out_rows`` =
    (lo, hi) as a new (hi - lo, L, B) plane (all t rows by default).
    Where the config's module has a one-launch step (``fused``: Poseidon at
    R_P >= 2) and the backend is not "plain", the step is that launch, or
    its plain version on the CPU under "auto" ("kernel" refuses a CPU
    tensor): a ``sponge.absorb_fused`` span around a ``sponge.permute``
    span, both counting the lanes; a tag is folded into the first round's
    constants (``PoseidonPermutation.tagged``), so the launch is the same.
    Every other config or backend runs ``add_rows`` (of the two planes'
    ``cat``) on the state, or on a zero state with the tag's capacity rows
    (``tag_plane``), the permutation (a ``sponge.permute`` span) and a copy
    of the rows kept, as a sponge does."""
    views = (rows,) if rows2 is None else (rows, rows2)
    k = sum(v.shape[0] for v in views)
    if start < 0 or start + k > cfg.rate:
        raise ValueError(f"{k} rows from rate position {start} pass the rate {cfg.rate}")
    if tag is not None:
        if state is not None:
            raise ValueError("a tag sets a fresh sponge's capacity; this step absorbs into a state")
        tag = capacity_tag(cfg, tag)
    lanes = rows.shape[-1]
    perm = permutation_for(cfg, rows.device)
    if perm.fused and backend != "plain":
        check_backend(backend, rows.device)
        with annotate(ABSORB_FUSED, lanes), annotate(PERMUTE, lanes):
            kept = (0, cfg.t) if out_rows is None else out_rows
            return perm.step(state, cfg.capacity + start, views, kept, tag)
    if state is None:
        state = zero_state(cfg, lanes, rows.device)
        if tag is not None:
            state[: cfg.capacity] = tag_plane(cfg, tag, rows.device)[..., None]
    if k:
        state = add_rows(cfg, state, start, rows if rows2 is None else torch.cat(views))
    with annotate(PERMUTE, lanes):
        state = perm(state, backend)
    return state if out_rows is None else state[out_rows[0] : out_rows[1]].clone()


def permute(cfg: SpongeConfig, state: torch.Tensor) -> torch.Tensor:
    """The plain permutation (the JAX package's ``permute`` tier)."""
    return batched_permute(cfg, state, "plain")


def zero_state(cfg: SpongeConfig, batch: int, device) -> torch.Tensor:
    """Zero-initialized sponge states; zero is 0 in Montgomery form."""
    return torch.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=torch.int32, device=device)


def capacity_tag(cfg: SpongeConfig, tag) -> tuple:
    """``tag`` as the tuple of the ``capacity`` canonical field values a
    fresh sponge's capacity starts from (a domain tag); anything else
    raises."""
    tag = tuple(int(v) for v in tag)
    if len(tag) != cfg.capacity:
        raise ValueError(f"a tag gives the {cfg.capacity} capacity rows; got {len(tag)} values")
    if not all(0 <= v < cfg.field.modulus for v in tag):
        raise ValueError("a tag's values must be canonical field elements, in [0, p)")
    return tag


def tag_plane(cfg: SpongeConfig, tag, device) -> torch.Tensor:
    """The capacity of a fresh sponge that starts from ``tag``
    (``capacity_tag``) as the (capacity, L) int32 plane of its Montgomery
    limbs on ``device``, which ``absorb_permute`` writes into a zero state
    where it adds the rows apart.  Built and copied to the device once per
    field, tag and device."""
    return _tag_plane(cfg.field, capacity_tag(cfg, tag), torch.device(device))


@functools.lru_cache(maxsize=64)
def _tag_plane(fs: FieldSpec, tag: tuple, device: torch.device) -> torch.Tensor:
    limbs = [fs.int_to_limbs(fs.to_mont(v)).tolist() for v in tag]
    return torch.tensor(limbs, dtype=torch.int32).to(device)
