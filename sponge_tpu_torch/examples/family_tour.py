"""One sponge API, seven permutation families.

Everything above the permutation (the duplex sponge, the absorb codec,
transcripts, Merkle trees, checkpoints, sharding) is config-agnostic: a
config type provides a ``batched_permute`` hook and an oracle, and the
whole port runs over it.

Run: python -m sponge_tpu_torch.examples.family_tour [--device cpu] [--lanes N] [--only NAME]
"""

from __future__ import annotations

import argparse

from .. import (
    BLS12_381_FR,
    GOLDILOCKS_FR,
    KOALABEAR_FR,
    MERSENNE31_FR,
    U64,
    Fp,
    PoseidonSponge,
    get_default_anemoi_parameters,
    get_default_gmimc_parameters,
    get_default_griffin_parameters,
    get_default_monolith_parameters,
    get_default_poseidon2_parameters,
    get_default_poseidon_parameters,
    get_default_rescue_parameters,
)
from . import describe, device_of


def configs() -> list:
    """(name, config) of the tour, in order."""
    return [
        ("Poseidon / BLS12-381 (the reference instance)",
         get_default_poseidon_parameters(BLS12_381_FR, rate=2)),
        ("Poseidon2 / KoalaBear", get_default_poseidon2_parameters(KOALABEAR_FR, 8)),
        ("Rescue-Prime / Mersenne31", get_default_rescue_parameters(MERSENNE31_FR, 8)),
        ("Monolith / Goldilocks", get_default_monolith_parameters(GOLDILOCKS_FR)),
        ("Griffin / Goldilocks", get_default_griffin_parameters(GOLDILOCKS_FR, 4)),
        ("Anemoi / Goldilocks", get_default_anemoi_parameters(GOLDILOCKS_FR, 4)),
        ("GMiMC-erf / Goldilocks", get_default_gmimc_parameters(GOLDILOCKS_FR, 4)),
    ]


def main(device="cuda", lanes: int = 8, only: str = ""):
    """Drive each config (those whose name starts with ``only``) through
    absorb, fork, squeeze and a state round trip on ``lanes`` lanes in
    lockstep.  Returns {name: (challenge, forked bytes)} of lane 0."""
    dev = device_of(device)
    print(f"device: {describe(dev)}")
    out = {}
    for name, cfg in configs():
        if not name.startswith(only):
            continue
        fs = cfg.field
        s = PoseidonSponge(cfg, batch_size=lanes, device=dev)
        s.absorb(b"domain: example")  # bytes (u64-length-prefixed packing)
        s.absorb(U64(42))  # typed ints
        s.absorb([Fp(3, fs), Fp(5, fs)])  # field elements
        sub = s.fork(b"sub-protocol")  # domain separation
        c = s.squeeze_native_field_elements(1)[0][0]
        b = sub.squeeze_bytes(8)[0]
        s2 = PoseidonSponge.from_state(s.into_state(), cfg, device=dev)  # SpongeExt checkpoint
        if s2.squeeze_native_field_elements(1) != s.squeeze_native_field_elements(1):
            raise AssertionError(f"{name}: the restored sponge squeezes differently")
        print(f"  {name}: challenge={c}  forked_bytes={b.hex()}")
        out[name] = (c, b)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--only", default="", help="run the configs whose name starts with this")
    args = ap.parse_args()
    main(args.device, args.lanes, args.only)
