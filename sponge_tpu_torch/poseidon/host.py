"""Native host-runtime sponges (C++ backend, bit-exact against the oracle).

Counterpart of ``sponge_tpu/poseidon/host.py``.  Provers hash huge batches
on the card; verifiers and transcript checkers run a handful of
permutations on a CPU, where a device round trip dwarfs the arithmetic.
This module serves the latter: a scalar 4 x 64-bit Montgomery permutation
and a whole-schedule duplex driver for every family in C++
(``csrc/host/poseidon_host.cc``), loaded through ctypes.

* :class:`HostPoseidonSponge` (and one subclass per family): the oracle
  sponge whose ``permute`` runs natively.  Every oracle surface (absorb
  codec, squeeze bytes/bits/non-native, fork, ``SpongeExt``) is inherited.
* :func:`host_run_schedule`: an entire absorb/squeeze schedule (the step
  language of ``transcript.compile_transcript``) in one native call, with
  the duplex mode flips and the no-permute squeeze quirk.
* :func:`host_permute_states`: a batch of states, over worker threads.

The native words use R = 2^256 (``_to_mont_words``), not the limb planes'
R = 2^(24 L) of ``FieldSpec.to_mont``: host tables are never built through
the field spec.  Without a C++ compiler (or for a > 256-bit field, or an
alpha outside uint31) ``HostPoseidonSponge`` falls back to the oracle's
permutation and the two functions raise ``RuntimeError``; callers check
:func:`host_available`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..anemoi.config import AnemoiConfig
from ..anemoi.oracle import OracleAnemoiSponge
from ..gmimc.config import GmimcConfig
from ..gmimc.oracle import OracleGmimcSponge
from ..griffin.config import GriffinConfig
from ..griffin.oracle import OracleGriffinSponge
from ..monolith.config import MonolithConfig, bar_m
from ..monolith.oracle import OracleMonolithSponge
from ..poseidon2.config import Poseidon2Config
from ..poseidon2.oracle import OraclePoseidon2Sponge
from ..rescue.config import RescueConfig
from ..rescue.oracle import OracleRescueSponge
from ..utils.native import get_poseidon_lib
from .config import PoseidonConfig
from .optimized import optimized_partial_layers
from .oracle import ABSORBING, SQUEEZING, OraclePoseidonSponge, SpongeState

_R_BITS = 256  # native word radix: 4 x 64-bit limbs
_R = 1 << _R_BITS


def _supported(cfg) -> bool:
    p = cfg.field.modulus
    if isinstance(cfg, MonolithConfig):
        # Bars run on a single canonical u64 word in the native runtime.
        return p % 2 == 1 and p.bit_length() <= 64
    return p % 2 == 1 and p.bit_length() <= _R_BITS and 1 <= cfg.alpha < (1 << 31)


def host_available(cfg) -> bool:
    """True when the native runtime can serve this config."""
    return _supported(cfg) and get_poseidon_lib() is not None


def _to_mont_words(p: int, values) -> np.ndarray:
    """Canonical ints -> (n, 4) u64 LE Montgomery-form words (R = 2^256)."""
    buf = b"".join(((v << _R_BITS) % p).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _rinv(p: int) -> int:
    return pow(_R, -1, p)


def _from_mont_words(p: int, words: np.ndarray) -> list:
    """(n, 4) u64 LE Montgomery-form words -> canonical ints."""
    rinv = _rinv(p)
    raw = np.ascontiguousarray(words, dtype=np.uint64).tobytes()
    return [int.from_bytes(raw[i : i + 32], "little") * rinv % p for i in range(0, len(raw), 32)]


def _words(p: int, values) -> np.ndarray:
    """Flat contiguous Montgomery words of ``values`` (one dummy zero row
    when empty, so the pointer is valid)."""
    return np.ascontiguousarray(_to_mont_words(p, list(values) or [0]).reshape(-1))


def _plain_words(x: int) -> np.ndarray:
    """A plain (non-Montgomery) 256-bit value as 4 u64 LE words."""
    return np.frombuffer(x.to_bytes(32, "little"), dtype=np.uint64).copy()


@dataclass(frozen=True)
class _HostTables:
    """One config's native call: the entry points ``<family>_permute_host``
    and ``<family>_sponge_run`` take ``fctx, *scalars`` (the sponge run then
    ``rate, capacity``), then one pointer per array (None = NULL)."""

    family: str
    fctx: np.ndarray  # (5,) u64: p (4 LE words) + n0inv
    scalars: tuple
    arrays: tuple

    @property
    def ptrs(self) -> tuple:
        return tuple(0 if a is None else a.ctypes.data for a in self.arrays)


def _fctx(p: int) -> np.ndarray:
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    return fctx


def _flat(rows) -> list:
    return [v for row in rows for v in row]


@functools.lru_cache(maxsize=32)
def _tables(cfg: PoseidonConfig) -> _HostTables:
    p = cfg.field.modulus
    opt = None
    if cfg.partial_rounds >= 2:
        # The sparse factorisation the kernels use (2t-1 products per partial
        # round instead of t^2), flattened in the order the C++ reads it.
        lay = optimized_partial_layers(cfg)
        flat = list(lay.c_first) + _flat(lay.constants)
        flat += _flat(sp.row0 for sp in lay.sparse) + _flat(sp.col0 for sp in lay.sparse)
        opt = _words(p, flat + _flat(lay.dense))
    return _HostTables(
        "poseidon", _fctx(p), (cfg.t, cfg.alpha, cfg.full_rounds, cfg.partial_rounds),
        (_words(p, _flat(cfg.ark)), _words(p, _flat(cfg.mds)), opt),
    )


@functools.lru_cache(maxsize=32)
def _tables2(cfg: Poseidon2Config) -> _HostTables:
    p = cfg.field.modulus
    dm1 = [(d - 1) % p for d in cfg.mat_i_diag]
    diag_small = (
        np.ascontiguousarray(np.asarray(dm1, dtype=np.int32))
        if all(v < (1 << 20) for v in dm1)
        else None
    )
    return _HostTables(
        "poseidon2", _fctx(p), (cfg.t, cfg.alpha, cfg.full_rounds, cfg.partial_rounds),
        (
            _words(p, _flat(cfg.external_rc)),
            _words(p, cfg.internal_rc),
            np.ascontiguousarray(np.asarray(cfg.mat_e, dtype=np.int32).reshape(-1)),
            _words(p, dm1),
            diag_small,
        ),
    )


@functools.lru_cache(maxsize=32)
def _tablesgm(cfg: GmimcConfig) -> _HostTables:
    p = cfg.field.modulus
    return _HostTables("gmimc", _fctx(p), (cfg.t, cfg.alpha, cfg.rounds), (_words(p, cfg.rc),))


@functools.lru_cache(maxsize=32)
def _tablesa(cfg: AnemoiConfig) -> _HostTables:
    p = cfg.field.modulus
    return _HostTables(
        "anemoi", _fctx(p), (cfg.t, cfg.alpha, cfg.rounds),
        (
            _words(p, _flat(cfg.rc_x)),
            _words(p, _flat(cfg.rc_y)),
            _words(p, _flat(cfg.mat_x)),
            _words(p, [cfg.g]),
            _words(p, [cfg.g_inv]),
            _plain_words(cfg.inv_alpha),
            _plain_words(_R % p),  # Montgomery 1
        ),
    )


@functools.lru_cache(maxsize=32)
def _tablesg(cfg: GriffinConfig) -> _HostTables:
    p = cfg.field.modulus
    coeffs = [cfg.quad_coeffs(i) for i in range(2, cfg.t)]
    return _HostTables(
        "griffin", _fctx(p), (cfg.t, cfg.alpha, cfg.rounds),
        (
            _words(p, _flat(cfg.rc)),
            np.ascontiguousarray(np.asarray(cfg.mat_e, dtype=np.int32).reshape(-1)),
            _words(p, [a for a, _ in coeffs]),
            _words(p, [b for _, b in coeffs]),
            _plain_words(cfg.inv_alpha),
            _plain_words(_R % p),
        ),
    )


@functools.lru_cache(maxsize=32)
def _tablesr(cfg: RescueConfig) -> _HostTables:
    p = cfg.field.modulus
    return _HostTables(
        "rescue", _fctx(p), (cfg.t, cfg.alpha, cfg.rounds),
        (
            _words(p, _flat(cfg.rc)),
            _words(p, _flat(cfg.mds)),
            _plain_words(cfg.inv_alpha),
            _plain_words(_R % p),
        ),
    )


@functools.lru_cache(maxsize=32)
def _tablesm(cfg: MonolithConfig) -> _HostTables:
    fs = cfg.field
    p = fs.modulus
    return _HostTables(
        "monolith", _fctx(p), (cfg.t, cfg.rounds, cfg.bars, fs.modulus_bit_size, bar_m(fs)),
        (
            _words(p, _flat(cfg.rc)),
            _words(p, _flat(cfg.concrete)),
            _plain_words(_R * _R % p),  # the to-Montgomery factor R^2 mod p
        ),
    )


_BUILDERS = (
    (GmimcConfig, _tablesgm),
    (AnemoiConfig, _tablesa),
    (GriffinConfig, _tablesg),
    (RescueConfig, _tablesr),
    (MonolithConfig, _tablesm),
    (Poseidon2Config, _tables2),
    (PoseidonConfig, _tables),
)


def _family_tables(cfg) -> _HostTables:
    for kind, build in _BUILDERS:
        if isinstance(cfg, kind):
            return build(cfg)
    raise TypeError(f"no native host runtime for {type(cfg).__name__}")


def _call_permute(lib, cfg, plane: np.ndarray, n: int, n_threads: int, tab=None) -> None:
    """The native batch permute of the config's family, in place on
    ``plane`` ((n, t, 4) u64 Montgomery words).

    ``tab``: the resolved tables; pass them on per-permute hot paths to skip
    the ``lru_cache`` lookup, which hashes the whole config.
    """
    tab = tab if tab is not None else _family_tables(cfg)
    getattr(lib, f"{tab.family}_permute_host")(
        tab.fctx.ctypes.data, *tab.scalars, *tab.ptrs, plane.ctypes.data, n, n_threads
    )


def host_permute_states(cfg, states, n_threads: int = 0) -> list:
    """Permute ``n`` canonical-int states (a flat list of n*t ints) natively.

    ``n_threads``: worker threads for the batch; 0 = one per core (at most
    16) for 64 states or more, else one.  Returns the permuted flat list.
    Raises ``RuntimeError`` when the native runtime is unavailable.
    """
    lib = get_poseidon_lib()
    if lib is None or not _supported(cfg):
        raise RuntimeError("native host Poseidon runtime unavailable")
    t = cfg.t
    n, rem = divmod(len(states), t)
    if rem:
        raise ValueError(f"states length {len(states)} not a multiple of t={t}")
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16) if n >= 64 else 1
    plane = np.ascontiguousarray(_to_mont_words(cfg.field.modulus, states))
    _call_permute(lib, cfg, plane, n, n_threads)
    return _from_mont_words(cfg.field.modulus, plane)


class HostPoseidonSponge(OraclePoseidonSponge):
    """Oracle-API sponge whose permutation runs in the native C++ runtime.

    The state stays canonical Python ints, so ``SpongeExt``, clone, fork and
    every squeeze format are inherited verbatim; only ``permute`` crosses
    into C++.  Falls back to the oracle's permutation when the native
    library cannot be built, so constructing one never fails.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self._native = host_available(cfg)
        # Resolved once: hashing the config per permute would cost a
        # measurable share of the permutation.
        self._tab = _family_tables(cfg) if self._native else None
        self._lib = get_poseidon_lib() if self._native else None

    def permute(self):
        if not self._native:
            return super().permute()
        p = self.cfg.field.modulus
        plane = np.ascontiguousarray(_to_mont_words(p, self.state))
        _call_permute(self._lib, self.cfg, plane, 1, 1, tab=self._tab)
        self.state = _from_mont_words(p, plane)


class HostPoseidon2Sponge(HostPoseidonSponge, OraclePoseidon2Sponge):
    """The Poseidon2 oracle with the native permute.

    MRO (HostPoseidonSponge, OraclePoseidon2Sponge): ``permute`` resolves to
    the native dispatcher and its fallback ``super().permute()`` to the
    Poseidon2 oracle's schedule.
    """


class HostMonolithSponge(HostPoseidonSponge, OracleMonolithSponge):
    """The Monolith oracle with the native permute (same MRO pattern)."""


class HostRescueSponge(HostPoseidonSponge, OracleRescueSponge):
    """The Rescue-Prime oracle with the native permute (same MRO pattern)."""


class HostGriffinSponge(HostPoseidonSponge, OracleGriffinSponge):
    """The Griffin oracle with the native permute (same MRO pattern)."""


class HostAnemoiSponge(HostPoseidonSponge, OracleAnemoiSponge):
    """The Anemoi oracle with the native permute (same MRO pattern)."""


class HostGmimcSponge(HostPoseidonSponge, OracleGmimcSponge):
    """The GMiMC-erf oracle with the native permute (same MRO pattern)."""


_MODE_CODE = {ABSORBING: 0, SQUEEZING: 1}
_MODE_NAME = {0: ABSORBING, 1: SQUEEZING}
_STEP_CODE = {"absorb": 0, "squeeze": 1}


def host_run_schedule(cfg, steps, elems, state: SpongeState = None):
    """Run a whole absorb/squeeze schedule in one native call.

    ``steps``: a sequence of ``("absorb", n)`` / ``("squeeze", n)`` pairs;
    absorbs consume the next ``n`` canonical ints of ``elems``, squeezes
    emit ``n`` native field elements.  ``state``: the resume point (a
    ``SpongeState`` from an earlier run or ``into_state()``); None starts a
    fresh sponge.

    Returns ``(squeezed, new_state)``, ``squeezed`` the canonical outputs in
    schedule order.  Matches the duplex state machine of the oracle exactly,
    zero-element absorbs and the remaining == rate squeeze quirk included.
    """
    lib = get_poseidon_lib()
    if lib is None or not _supported(cfg):
        raise RuntimeError("native host Poseidon runtime unavailable")
    p = cfg.field.modulus
    step_arr = np.zeros((max(len(steps), 1), 2), dtype=np.int32)
    n_absorb = n_squeeze = 0
    for i, (kind, n) in enumerate(steps):
        if kind not in _STEP_CODE:
            raise ValueError(f"unknown step kind {kind!r}")
        step_arr[i] = (_STEP_CODE[kind], n)
        if kind == "absorb":
            n_absorb += n
        else:
            n_squeeze += n
    elems = list(elems)
    if len(elems) != n_absorb:
        raise ValueError(f"schedule absorbs {n_absorb} elements, got {len(elems)}")

    ein = np.ascontiguousarray(_to_mont_words(p, [e % p for e in elems] or [0]))
    out = np.zeros((max(n_squeeze, 1), 4), dtype=np.uint64)
    if state is None:
        state = SpongeState(state=[0] * cfg.t, mode=ABSORBING, index=0)
    st = np.ascontiguousarray(_to_mont_words(p, state.state))
    bk = np.array([_MODE_CODE[state.mode], state.index], dtype=np.int32)

    tab = _family_tables(cfg)
    getattr(lib, f"{tab.family}_sponge_run")(
        tab.fctx.ctypes.data, *tab.scalars, cfg.rate, cfg.capacity, *tab.ptrs,
        step_arr.ctypes.data, len(steps),
        ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
    )
    squeezed = _from_mont_words(p, out)[:n_squeeze]
    new_state = SpongeState(
        state=_from_mont_words(p, st), mode=_MODE_NAME[int(bk[0])], index=int(bk[1])
    )
    return squeezed, new_state
