"""Scalar python-int GMiMC-erf duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/gmimc/oracle.py``: the duplex state machine is
``OraclePoseidonSponge``'s; only the permutation differs.
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import GmimcConfig


class OracleGmimcSponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the GMiMC-erf permutation."""

    def __init__(self, cfg: GmimcConfig):
        super().__init__(cfg)

    def permute(self):
        cfg, p = self.cfg, self.f.p
        state = list(self.state)
        for c in cfg.rc:
            f = pow((state[0] + c) % p, cfg.alpha, p)
            state = [(x + f) % p for x in state[1:]] + [state[0]]
        self.state = state
