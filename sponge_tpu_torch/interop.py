"""Carry the JAX package's parameters and state planes across to the port.

The JAX package stores field elements as Montgomery limb planes of 12 (or
13) bits with ``R = 2^(limb_bits * L)``; the port uses 24-bit limbs with its
own R.  Every conversion here goes through canonical integers, so it serves
any of the JAX limb plans.  Inputs are numpy arrays (this module never
imports JAX): ``device_constants(cfg)``'s ``ark`` (R, t, L, 1) and ``mds``
(t, t, L, 1), ``device_constants2(cfg)``'s Poseidon2 tables, the Rescue,
GMiMC, Griffin and Anemoi tiers' ``_device_constants(cfg)``, and
``(t, L, B)`` state planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .anemoi.config import AnemoiConfig
from .fields import _FIELDS, FieldSpec, ints_to_mont_tensor, mont_tensor_to_ints
from .gmimc.config import GmimcConfig
from .griffin.config import GriffinConfig
from .poseidon.config import PoseidonConfig
from .poseidon2.config import Poseidon2Config
from .rescue.config import RescueConfig


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


def _field(modulus: int, field: FieldSpec = None) -> FieldSpec:
    fs = field if field is not None else field_for_modulus(modulus)
    if fs.modulus != modulus:
        raise ValueError("field modulus does not match the constants' modulus")
    return fs


def _rows(arr, modulus: int, limb_bits: int) -> tuple:
    """(n, m, L, 1) JAX Montgomery constants -> n rows of m canonical ints."""
    vals = jax_limbs_to_ints(arr, modulus, limb_bits)[..., 0]
    return tuple(tuple(int(v) for v in row) for row in vals)


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
    return PoseidonConfig(
        field=_field(modulus, field),
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        alpha=alpha,
        ark=_rows(ark, modulus, limb_bits),
        mds=_rows(mds, modulus, limb_bits),
        rate=rate,
        capacity=capacity,
    )


def poseidon2_config_from_device_constants(
    ext,
    internal,
    mat_e,
    diag_m1,
    *,
    modulus: int,
    limb_bits: int,
    alpha: int,
    rate: int,
    capacity: int = 1,
    field: FieldSpec = None,
) -> Poseidon2Config:
    """The port's ``Poseidon2Config`` from the JAX package's
    ``device_constants2(cfg)``: ext (R_F, t, L, 1), internal (R_P, L, 1) and
    diag_m1 (t, L, 1) as Montgomery limbs, mat_e (t, t) small ints."""
    internal = np.asarray(internal)
    diag_m1 = _rows(np.asarray(diag_m1)[None], modulus, limb_bits)[0]
    return Poseidon2Config(
        field=_field(modulus, field),
        full_rounds=np.asarray(ext).shape[0],
        partial_rounds=internal.shape[0],
        alpha=alpha,
        external_rc=_rows(ext, modulus, limb_bits),
        internal_rc=_rows(internal[None], modulus, limb_bits)[0] if internal.shape[0] else (),
        mat_e=tuple(tuple(int(v) for v in row) for row in np.asarray(mat_e)),
        mat_i_diag=tuple((v + 1) % modulus for v in diag_m1),
        rate=rate,
        capacity=capacity,
    )


def rescue_config_from_device_constants(
    rc,
    mds,
    *,
    modulus: int,
    limb_bits: int,
    alpha: int,
    rate: int,
    capacity: int = 1,
    field: FieldSpec = None,
) -> RescueConfig:
    """The port's ``RescueConfig`` from the JAX Rescue tier's
    ``_device_constants(cfg)``: rc (2N, t, L, 1) and mds (t, t, L, 1)."""
    rc_rows = _rows(rc, modulus, limb_bits)
    return RescueConfig(
        field=_field(modulus, field),
        rounds=len(rc_rows) // 2,
        alpha=alpha,
        mds=_rows(mds, modulus, limb_bits),
        rc=rc_rows,
        rate=rate,
        capacity=capacity,
    )


def gmimc_config_from_device_constants(
    rc, *, modulus: int, limb_bits: int, alpha: int, rate: int, capacity: int = 1,
    field: FieldSpec = None,
) -> GmimcConfig:
    """The port's ``GmimcConfig`` from the JAX GMiMC tier's
    ``_device_constants(cfg)``: rc (rounds, L, 1)."""
    rc = _rows(np.asarray(rc)[None], modulus, limb_bits)[0]
    return GmimcConfig(
        field=_field(modulus, field), rounds=len(rc), alpha=alpha, rc=rc, rate=rate,
        capacity=capacity,
    )


def griffin_config_from_device_constants(
    rc, mat_e, quads, *, modulus: int, limb_bits: int, alpha: int, rate: int,
    capacity: int = 1, field: FieldSpec = None,
) -> GriffinConfig:
    """The port's ``GriffinConfig`` from the JAX Griffin tier's
    ``_device_constants(cfg)``: rc (rounds, t, L, 1) with its zero last row,
    mat_e (t, t) small ints, and the gates' (alpha_i, beta_i) columns
    (L, 1), whose first pair (i = 2) is the base pair (a, b)."""
    rc_rows = _rows(rc, modulus, limb_bits)
    qc_alpha, qc_beta = _rows(np.stack(quads[0])[None], modulus, limb_bits)[0]
    return GriffinConfig(
        field=_field(modulus, field),
        rounds=len(rc_rows),
        alpha=alpha,
        mat_e=tuple(tuple(int(v) for v in row) for row in np.asarray(mat_e)),
        rc=rc_rows[:-1],
        qc_alpha=qc_alpha,
        qc_beta=qc_beta,
        rate=rate,
        capacity=capacity,
    )


def anemoi_config_from_device_constants(
    consts, *, modulus: int, limb_bits: int, alpha: int, rate: int, capacity: int = 1,
    field: FieldSpec = None,
) -> AnemoiConfig:
    """The port's ``AnemoiConfig`` from the JAX Anemoi tier's
    ``_device_constants(cfg)``: rc_x and rc_y (rounds, l, L, 1), ``mat`` of
    (L, 1) columns and ``g`` an (L, 1) column."""
    mat = np.asarray([[np.asarray(e) for e in row] for row in consts["mat"]])
    return AnemoiConfig(
        field=_field(modulus, field),
        rounds=np.asarray(consts["rc_x"]).shape[0],
        alpha=alpha,
        g=_rows(np.asarray(consts["g"])[None, None], modulus, limb_bits)[0][0],
        mat_x=_rows(mat, modulus, limb_bits),
        rc_x=_rows(consts["rc_x"], modulus, limb_bits),
        rc_y=_rows(consts["rc_y"], modulus, limb_bits),
        rate=rate,
        capacity=capacity,
    )


def config_from_jax(cfg):
    """The port's config of a JAX-package config, dispatched on its class
    name (``PoseidonConfig``, ``Poseidon2Config``, ``RescueConfig``,
    ``GmimcConfig``, ``GriffinConfig``, ``AnemoiConfig``) and read through
    its attributes, which are Python ints, over the port's field of the same
    modulus.  Any other class raises."""
    kind = type(cfg).__name__
    if kind not in ("PoseidonConfig", "Poseidon2Config", "RescueConfig", "GmimcConfig",
                    "GriffinConfig", "AnemoiConfig"):
        raise TypeError(f"no port counterpart of the JAX config class {kind}")
    ints = lambda rows: tuple(tuple(int(v) for v in row) for row in rows)  # noqa: E731
    common = dict(field=field_for_modulus(cfg.field.modulus), alpha=cfg.alpha, rate=cfg.rate,
                  capacity=cfg.capacity)
    if kind == "PoseidonConfig":
        return PoseidonConfig(
            full_rounds=cfg.full_rounds, partial_rounds=cfg.partial_rounds, ark=ints(cfg.ark),
            mds=ints(cfg.mds), **common,
        )
    if kind == "Poseidon2Config":
        return Poseidon2Config(
            full_rounds=cfg.full_rounds,
            partial_rounds=cfg.partial_rounds,
            external_rc=ints(cfg.external_rc),
            internal_rc=tuple(int(v) for v in cfg.internal_rc),
            mat_e=ints(cfg.mat_e),
            mat_i_diag=tuple(int(v) for v in cfg.mat_i_diag),
            **common,
        )
    if kind == "RescueConfig":
        return RescueConfig(rounds=cfg.rounds, mds=ints(cfg.mds), rc=ints(cfg.rc), **common)
    if kind == "GmimcConfig":
        return GmimcConfig(rounds=cfg.rounds, rc=tuple(int(v) for v in cfg.rc), **common)
    if kind == "GriffinConfig":
        return GriffinConfig(
            rounds=cfg.rounds, mat_e=ints(cfg.mat_e), rc=ints(cfg.rc), qc_alpha=int(cfg.qc_alpha),
            qc_beta=int(cfg.qc_beta), **common,
        )
    return AnemoiConfig(
        rounds=cfg.rounds, g=int(cfg.g), mat_x=ints(cfg.mat_x), rc_x=ints(cfg.rc_x),
        rc_y=ints(cfg.rc_y), **common,
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
