"""Poseidon configuration (counterpart of ``sponge_tpu/poseidon/config.py``).

A frozen, hashable dataclass whose round constants are Python ints; the
device form (24-bit Montgomery limb planes) is built by ``device_constants``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec


@dataclass(frozen=True)
class PoseidonConfig:
    """Parameters of the Poseidon permutation and the duplex sponge geometry.

    ``ark[round][element]`` is added before each S-box; ``mds`` is the t x t
    matrix; the state layout is ``capacity ‖ rate``.
    """

    field: FieldSpec
    full_rounds: int
    partial_rounds: int
    alpha: int
    ark: tuple  # (R, t) ints
    mds: tuple  # (t, t) ints
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        if len(self.ark) != self.full_rounds + self.partial_rounds:
            raise ValueError("ark must have full_rounds + partial_rounds rows")
        for row in self.ark:
            if len(row) != t:
                raise ValueError("each ark row must have rate + capacity entries")
        if len(self.mds) != t:
            raise ValueError("mds must have rate + capacity rows")
        for row in self.mds:
            if len(row) != t:
                raise ValueError("each mds row must have rate + capacity entries")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    def oracle_sponge(self):
        """A scalar python-int duplex sponge over this permutation: the
        hook every family config has."""
        from .oracle import OraclePoseidonSponge

        return OraclePoseidonSponge(self)


def mont_limb_rows(fs: FieldSpec, rows) -> np.ndarray:
    """Nested int rows -> int32 array of Montgomery limbs, limb axis last."""
    flat = [v for row in rows for v in row]
    limbs = fs.ints_to_mont_plane(flat).T  # (n, L)
    return np.ascontiguousarray(limbs.reshape(len(rows), len(rows[0]), fs.nlimbs))


@functools.lru_cache(maxsize=None)
def device_constants(cfg: PoseidonConfig):
    """Round constants in the port's layout (numpy, Montgomery, 24-bit limbs):

    * ``ark``: (R, t, L, 1) int32,
    * ``mds``: (t, t, L, 1) int32.

    The trailing singleton axis broadcasts over the batch axis, as in the JAX
    package's ``device_constants``.
    """
    fs = cfg.field
    return {
        "ark": mont_limb_rows(fs, cfg.ark)[..., None],
        "mds": mont_limb_rows(fs, cfg.mds)[..., None],
    }


def constant_layout(cfg: PoseidonConfig):
    """Sections of the flat constant buffer the CUDA kernels read, in order:
    ``(name, shape)`` with the limb axis last.  The dense kernel reads the
    first three; the sparse-factorized kernel all of them.  The same order is
    written out in csrc/poseidon_dense.cu and csrc/poseidon_opt.cu."""
    t, L, k = cfg.t, cfg.field.nlimbs, cfg.partial_rounds - 1
    layout = [("p", (L,)), ("ark", (cfg.rounds, t, L)), ("mds", (t, t, L))]
    if k >= 1:
        layout += [
            ("chat", (k, t, L)),
            ("row0", (k, t, L)),
            ("col0", (k, t - 1, L)),
            ("dense", (t, t, L)),
        ]
    return layout


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: PoseidonConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``: the modulus as plain limbs,
    everything else as Montgomery limbs.  Built once per config."""
    from .optimized import optimized_partial_layers

    fs = cfg.field
    parts = [fs.int_to_limbs(fs.modulus), mont_limb_rows(fs, cfg.ark), mont_limb_rows(fs, cfg.mds)]
    if cfg.partial_rounds >= 2:
        layers = optimized_partial_layers(cfg)
        parts += [
            mont_limb_rows(fs, layers.constants),
            mont_limb_rows(fs, [sp.row0 for sp in layers.sparse]),
            mont_limb_rows(fs, [sp.col0 for sp in layers.sparse]),
            mont_limb_rows(fs, layers.dense),
        ]
    return np.concatenate([a.reshape(-1) for a in parts]).astype(np.int32)


def layout_size(layout) -> int:
    """Words in a flat constant buffer laid out by ``layout`` (every kernel
    launch checks its buffer against it: plain ints, no numpy call)."""
    return sum(math.prod(shape) for _, shape in layout)


def unpack_layout(layout, buf):
    """Views of a flat (device) buffer by the sections of ``layout``, each
    with a trailing batch axis of 1 so it broadcasts over (.., L, B) planes."""
    need = layout_size(layout)
    if tuple(buf.shape) != (need,):
        raise ValueError(f"constant buffer has shape {tuple(buf.shape)}, layout needs ({need},)")
    out, off = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        out[name] = buf[off : off + n].reshape(shape + (1,))
        off += n
    return out


def unpack_constants(cfg: PoseidonConfig, buf):
    """Views of a (device) constant buffer by section (``unpack_layout``)."""
    return unpack_layout(constant_layout(cfg), buf)
