"""Carry the JAX package's parameters and state planes across to the port.

The JAX package stores field elements as Montgomery limb planes of 12 (or
13) bits with ``R = 2^(limb_bits * L)``; the port uses 24-bit limbs with its
own R.  Every conversion here goes through canonical integers, so it serves
any of the JAX limb plans.  Inputs are numpy arrays (this module never
imports JAX): ``device_constants(cfg)``'s ``ark`` (R, t, L, 1) and ``mds``
(t, t, L, 1), and ``(t, L, B)`` state planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import _FIELDS, FieldSpec, ints_to_mont_tensor, mont_tensor_to_ints
from .poseidon.config import PoseidonConfig


def jax_limbs_to_ints(arr, modulus: int, limb_bits: int) -> np.ndarray:
    """(..., L, B) JAX Montgomery limbs (possibly redundant) -> object array
    (..., B) of canonical ints."""
    arr = np.asarray(arr).astype(object)
    L = arr.shape[-2]
    r_inv = pow(1 << (limb_bits * L), -1, modulus)
    value = sum(arr[..., k, :] << (limb_bits * k) for k in range(L))
    return np.vectorize(lambda v: int(v) * r_inv % modulus, otypes=[object])(value)


def ints_to_jax_limbs(values, modulus: int, limb_bits: int, nlimbs: int) -> np.ndarray:
    """Object array (..., B) of canonical ints -> (..., L, B) int32 JAX
    Montgomery limbs (canonical limbs)."""
    values = np.asarray(values, dtype=object)
    r = 1 << (limb_bits * nlimbs)
    mont = np.vectorize(lambda v: int(v) * r % modulus, otypes=[object])(values)
    mask = (1 << limb_bits) - 1
    limbs = [
        np.vectorize(lambda v, k=k: (int(v) >> (limb_bits * k)) & mask, otypes=[np.int64])(mont)
        for k in range(nlimbs)
    ]
    return np.stack(limbs, axis=-2).astype(np.int32)


def field_for_modulus(modulus: int) -> FieldSpec:
    """The shipped port field with this modulus, else an ad-hoc FieldSpec."""
    for fs in _FIELDS.values():
        if fs.modulus == modulus:
            return fs
    return FieldSpec(name=f"fp_{modulus:x}", modulus=modulus, generator=0)


def config_from_device_constants(
    ark,
    mds,
    *,
    modulus: int,
    limb_bits: int,
    full_rounds: int,
    partial_rounds: int,
    alpha: int,
    rate: int,
    capacity: int = 1,
    field: FieldSpec = None,
) -> PoseidonConfig:
    """The port's ``PoseidonConfig`` from the JAX package's device constants
    (ark (R, t, L, 1), mds (t, t, L, 1), 12- or 13-bit Montgomery limbs)."""
    fs = field if field is not None else field_for_modulus(modulus)
    if fs.modulus != modulus:
        raise ValueError("field modulus does not match the constants' modulus")

    def rows(arr):
        vals = jax_limbs_to_ints(arr, modulus, limb_bits)[..., 0]
        return tuple(tuple(int(v) for v in row) for row in vals)

    return PoseidonConfig(
        field=fs,
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        alpha=alpha,
        ark=rows(ark),
        mds=rows(mds),
        rate=rate,
        capacity=capacity,
    )


def config_from_jax(cfg) -> PoseidonConfig:
    """The port's config of a JAX-package ``PoseidonConfig`` (read through its
    attributes, which are Python ints), over the port's field of the same
    modulus."""
    return PoseidonConfig(
        field=field_for_modulus(cfg.field.modulus),
        full_rounds=cfg.full_rounds,
        partial_rounds=cfg.partial_rounds,
        alpha=cfg.alpha,
        ark=tuple(tuple(int(v) for v in row) for row in cfg.ark),
        mds=tuple(tuple(int(v) for v in row) for row in cfg.mds),
        rate=cfg.rate,
        capacity=cfg.capacity,
    )


def plane_from_jax(plane, fs: FieldSpec, limb_bits: int, device) -> torch.Tensor:
    """JAX (..., L_jax, B) Montgomery plane -> the port's (..., L, B) int32
    canonical Montgomery plane on ``device``."""
    vals = jax_limbs_to_ints(plane, fs.modulus, limb_bits)
    rows = [list(row) for row in vals.reshape(-1, vals.shape[-1])]
    out = ints_to_mont_tensor(fs, rows, device)  # (k, L, B)
    return out.reshape(vals.shape[:-1] + (fs.nlimbs, vals.shape[-1]))


def plane_to_jax(plane: torch.Tensor, fs: FieldSpec, limb_bits: int, jax_nlimbs: int) -> np.ndarray:
    """The port's (..., L, B) plane -> JAX (..., L_jax, B) int32 Montgomery
    limbs for a plan of ``limb_bits``-bit limbs, ``jax_nlimbs`` of them."""
    flat = plane.reshape((-1,) + tuple(plane.shape[-2:]))
    vals = np.asarray([mont_tensor_to_ints(fs, p) for p in flat], dtype=object)
    out = ints_to_jax_limbs(vals, fs.modulus, limb_bits, jax_nlimbs)
    return out.reshape(tuple(plane.shape[:-2]) + (jax_nlimbs, plane.shape[-1]))
