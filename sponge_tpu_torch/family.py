"""The permutation module of every family beside Poseidon.

A family (``poseidon2/``, ``rescue/``, ``gmimc/``, ``griffin/``,
``anemoi/``) subclasses ``FamilyPermutation`` and
names three functions: its kernel wrapper and its plain version, both
``(cfg, consts, state) -> state`` over ``(t, L, B)`` planes, and the numpy
constant buffer of a config.  The module holds that buffer as a registered
buffer; ``permutation_for`` keeps one module per (family, config, device).
Backends:

* ``"auto"``: the family's CUDA kernel for a CUDA tensor, its plain version
  for a CPU tensor (the wrapper decides by the tensor's device);
* ``"kernel"``: the CUDA kernel; a CPU tensor raises;
* ``"plain"``: the plain PyTorch permutation, on any device.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

BACKENDS = ("auto", "kernel", "plain")


class FamilyPermutation(nn.Module):
    """One config's permutation as a module (one int32 constant buffer, no
    parameters).  Subclasses set ``kernel``, ``plain`` and ``constants``."""

    kernel = plain = constants = None

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        consts = torch.from_numpy(self.constants(cfg))
        self.register_buffer("consts", consts.to(device), persistent=False)

    @torch.no_grad()
    def forward(self, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        if backend == "plain":
            return self.plain(self.cfg, self.consts, state)
        if backend == "kernel" and state.device.type != "cuda":
            raise ValueError(f"backend='kernel' runs a CUDA kernel; the state is on {state.device}")
        if backend in ("auto", "kernel"):
            return self.kernel(self.cfg, self.consts, state)
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


@functools.lru_cache(maxsize=None)
def permutation_for(family: type, cfg, device: torch.device) -> FamilyPermutation:
    """The cached ``family`` module of ``cfg`` with its buffer on ``device``."""
    return family(cfg, device)
