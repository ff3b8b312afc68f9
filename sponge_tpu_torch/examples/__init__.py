"""Runnable examples of the port (counterparts of the JAX package's
``examples/``), each ``python -m sponge_tpu_torch.examples.<name>``:

* ``fiat_shamir``: a batch of transcripts proved on the card, one lane
  verified on the host in one native call;
* ``merkle_commitment``: a Monolith/Goldilocks Merkle commitment with a
  batch of proofs opened and verified, and one tampered proof refused;
* ``family_tour``: one sponge API over the seven permutation families.

Each runs on the card unless the caller asks for the CPU (``--device
cpu``); asked for the card where there is none, it raises.
"""

import torch


def device_of(device) -> torch.device:
    """``device`` as a torch device; raises for a CUDA device that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card unless asked for --device cpu")
    return dev


def describe(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
