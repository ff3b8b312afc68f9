"""Checkpoint and resume of sponges and Merkle levels.

Counterpart of ``sponge_tpu/checkpoint.py``, with the same ``.npz`` layout,
so files cross between the two packages: a sponge file holds its state as
decimal strings of the canonical values, with the duplex mode and index; a
Merkle-level file holds the int32 limb plane of the JAX package's limb plan
(12-bit limbs, the plan of its default fields).  Either file carries the
config's fingerprint and is refused under another config.

The fingerprint is the JAX package's, byte for byte: a sha256 over every
dataclass field of the config, and the geometry in clear.  The JAX package
reads ``alpha``, ``full_rounds`` and ``partial_rounds`` of every config, and
so fails on the families that lack them; here each of those keys is written
only where the config has it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from .interop import plane_from_jax, plane_to_jax
from .poseidon.oracle import SpongeState
from .poseidon.permutation import SpongeConfig
from .sponge import PoseidonSponge

JAX_LIMB_BITS = (12, 13)  # the JAX package's limb plans; it writes with the first


def _json_safe(v):
    if isinstance(v, int):
        return str(v)  # field elements of any size, as decimal strings
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    return v


def _cfg_fingerprint(cfg: SpongeConfig) -> str:
    tables = {"modulus": str(cfg.field.modulus)}
    for f in dataclasses.fields(cfg):
        if f.name != "field":
            tables[f.name] = _json_safe(getattr(cfg, f.name))
    tables_hash = hashlib.sha256(json.dumps(tables, sort_keys=True).encode()).hexdigest()
    head = {
        "version": 2,
        "kind": type(cfg).__name__,
        "field": cfg.field.name,
        "rate": cfg.rate,
        "capacity": cfg.capacity,
    }
    for key in ("alpha", "full_rounds", "partial_rounds"):
        if hasattr(cfg, key):
            head[key] = getattr(cfg, key)
    head["tables_sha256"] = tables_hash
    return json.dumps(head)


def _check(z, kind: str, cfg: SpongeConfig) -> None:
    if str(z["kind"]) != kind:
        raise ValueError(f"not a {kind.replace('_', '-')} checkpoint")
    if str(z["config"]) != _cfg_fingerprint(cfg):
        raise ValueError("checkpoint was produced under a different config")


def save_sponge(path, sponge: PoseidonSponge) -> None:
    """Snapshot a batched sponge: its state and duplex bookkeeping."""
    state = sponge.into_state()
    width = len(str(sponge.cfg.field.modulus))  # every value is below p
    np.savez(
        path,
        kind="sponge",
        config=_cfg_fingerprint(sponge.cfg),
        mode=state.mode,
        index=state.index,
        values=np.asarray([[str(v) for v in row] for row in state.state], dtype=f"U{width}"),
    )


def load_sponge(path, cfg: SpongeConfig, *, device) -> PoseidonSponge:
    """Restore a sponge saved by ``save_sponge`` (either package) on
    ``device``; the file must carry ``cfg``'s fingerprint."""
    with np.load(path, allow_pickle=False) as z:
        _check(z, "sponge", cfg)
        rows = [[int(v) for v in row] for row in z["values"]]
        state = SpongeState(state=rows, mode=str(z["mode"]), index=int(z["index"]))
    return PoseidonSponge.from_state(state, cfg, device=device)


def _jax_nlimbs(cfg: SpongeConfig, limb_bits: int) -> int:
    return -(-(cfg.field.modulus.bit_length() + 4) // limb_bits)


def save_merkle_level(path, cfg: SpongeConfig, level: torch.Tensor, depth: int) -> None:
    """Snapshot one (..., L, N) Merkle level at ``depth`` as the JAX
    package's int32 plane (12-bit limbs)."""
    bits = JAX_LIMB_BITS[0]
    plane = plane_to_jax(level, cfg.field, bits, _jax_nlimbs(cfg, bits))
    np.savez_compressed(
        path, kind="merkle_level", config=_cfg_fingerprint(cfg), depth=depth, plane=plane
    )


def load_merkle_level(path, cfg: SpongeConfig, *, device):
    """-> (the port's (..., L, N) level plane on ``device``, depth).  A JAX
    plane's limb plan follows from its limb count (at BLS12-381: 22 limbs
    of 12 bits, or 20 of 13).  Resume with ``hash.merkle_root`` on it."""
    with np.load(path, allow_pickle=False) as z:
        _check(z, "merkle_level", cfg)
        plane, depth = z["plane"], int(z["depth"])
    for bits in JAX_LIMB_BITS:
        if plane.shape[-2] == _jax_nlimbs(cfg, bits):
            return plane_from_jax(plane, cfg.field, bits, device), depth
    raise ValueError(f"a {plane.shape[-2]}-limb plane matches no JAX limb plan of {cfg.field.name}")
