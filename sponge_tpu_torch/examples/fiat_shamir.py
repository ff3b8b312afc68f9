"""End-to-end Fiat-Shamir: a batch of transcripts proved on the card, one
lane replayed by the verifier on the host runtime, with identical challenges.

  prover   : B independent transcripts advance in lockstep on the card
             (``compile_transcript``: a chain of batched permutations);
  verifier : one transcript replayed on the CPU in one native call
             (``host_run_schedule``).

Run: python -m sponge_tpu_torch.examples.fiat_shamir [--device cpu] [--lanes N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import BLS12_381_FR as FR
from .. import get_default_poseidon_parameters
from ..fields import limbs_to_ints
from ..poseidon.host import host_available, host_run_schedule
from ..poseidon.oracle import OraclePoseidonSponge
from ..transcript import Absorb, SqueezeNative, compile_transcript
from . import describe, device_of

# The protocol: absorb 3 commitments, draw 2 challenges, absorb the
# response, draw the final challenge.
SCHEDULE = (Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(1))
STEPS = (("absorb", 3), ("squeeze", 2), ("absorb", 1), ("squeeze", 1))
SEED = 0  # the messages' generator


def oracle_challenges(cfg, absorbed) -> list:
    o = OraclePoseidonSponge(cfg)
    o.absorb_field_elements(absorbed[:3])
    out = o.squeeze_native_field_elements(2)
    o.absorb_field_elements(absorbed[3:])
    return out + o.squeeze_native_field_elements(1)


def main(device="cuda", lanes: int = 256):
    """Prove ``lanes`` transcripts on ``device`` and verify lane 7 (or the
    last) on the host.  Returns the messages ((4, lanes) ints), their
    Montgomery element plane ((4, L, lanes)) and the challenge plane ((3, L,
    lanes) canonical limbs), the planes on the device."""
    dev = device_of(device)
    cfg = get_default_poseidon_parameters(FR, rate=2)
    msgs = np.random.default_rng(SEED).integers(0, 1 << 62, size=(4, lanes))  # 3 commitments, 1 response
    elems = torch.from_numpy(np.stack([FR.ints_to_mont_plane(row.tolist()) for row in msgs])).to(dev)
    challenges = compile_transcript(cfg, SCHEDULE)(elems)  # (3, L, lanes)
    print(f"prover: {lanes} transcripts x {challenges.shape[0]} challenges on {describe(dev)}")

    lane = min(7, lanes - 1)
    absorbed = [int(v) for v in msgs[:, lane]]
    if host_available(cfg):
        squeezed, _ = host_run_schedule(cfg, STEPS, absorbed)
        where = "native host runtime (one C++ call)"
    else:
        squeezed = oracle_challenges(cfg, absorbed)
        where = "python oracle (no C++ compiler)"
    device_view = [limbs_to_ints(FR, row[:, lane : lane + 1].cpu().numpy())[0] for row in challenges]
    if squeezed != device_view:
        raise AssertionError(f"lane {lane}: host {squeezed} != device {device_view}")
    print(f"verifier ({where}): challenges match the device transcript lane")
    print(f"lane {lane} challenges = {squeezed}")
    return msgs, elems, challenges


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=256)
    args = ap.parse_args()
    main(args.device, args.lanes)
