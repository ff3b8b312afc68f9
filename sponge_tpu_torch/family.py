"""The permutation module of every family, and the one dispatch to it.

A family (``poseidon/``, ``poseidon2/``, ``rescue/``, ``gmimc/``,
``griffin/``, ``anemoi/``, ``monolith/``) subclasses ``FamilyPermutation``
with its config class (``class RescuePermutation(FamilyPermutation,
config=RescueConfig)``), which enters the subclass in ``MODULES``, and
names three functions: its kernel wrapper and its plain version, both
``(cfg, consts, state) -> state`` over ``(t, L, B)`` planes, and the numpy
constant buffer of a config.  The module holds that buffer, and any in
``extra``, as registered buffers; ``permutation_for`` keeps one module per
(config, device).  Backends (``BACKENDS``), the same for every family:

* ``"auto"``: the family's CUDA kernel for a CUDA tensor, its plain version
  for a CPU tensor (the wrapper decides by the tensor's device);
* ``"kernel"``: the CUDA kernel; a CPU tensor raises;
* ``"plain"``: the plain PyTorch permutation, on any device.

A module whose ``fused`` is true also has ``step``, a sponge step (rows
added, the permutation, the rows kept) in one launch of its kernel;
``poseidon.permutation.absorb_permute`` takes it.  One whose
``overwrites`` is true has ``overwrite``, Plonky3's overwrite sponge (a
zero state, chunks of rows written over its first rows, each followed by
the permutation, the first rows kept) in one launch;
``poseidon.permutation.overwrite_permute`` takes it.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

BACKENDS = ("auto", "kernel", "plain")

MODULES: dict[type, type] = {}  # config class -> its family's module class


def check_backend(backend: str, device: torch.device) -> None:
    """Raise for a backend not in ``BACKENDS``, and for "kernel" off CUDA."""
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(f"backend='kernel' runs a CUDA kernel; the state is on {device}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


class FamilyPermutation(nn.Module):
    """One config's permutation as a module (int32 constant buffers, no
    parameters).  Subclasses set ``kernel``, ``plain`` and ``constants``,
    and may name further buffers in ``extra`` (name -> the function making
    its numpy array from the config)."""

    kernel = plain = constants = None
    extra: dict = {}
    fused = overwrites = False

    def __init_subclass__(cls, config: type | None = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if config is not None:
            MODULES[config] = cls

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        for name, build in {"consts": self.constants, **self.extra}.items():
            self.register_buffer(name, torch.from_numpy(build(cfg)).to(device), persistent=False)

    @torch.no_grad()
    def forward(self, state: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        if backend == "plain":
            return self.plain(self.cfg, self.consts, state)
        check_backend(backend, state.device)
        return self.kernel(self.cfg, self.consts, state)


@functools.lru_cache(maxsize=None)
def permutation_for(cfg, device: torch.device) -> FamilyPermutation:
    """The cached module of ``cfg``'s family with its buffers on ``device``;
    a config no family registered (a JAX package's config) raises."""
    if type(cfg) not in MODULES:
        raise NotImplementedError(f"{type(cfg).__name__}: not a config of the PyTorch port")
    return MODULES[type(cfg)](cfg, device)
