"""Scalar python-int Rescue-Prime duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/rescue/oracle.py``: the duplex state machine is
``OraclePoseidonSponge``'s; only the permutation differs.
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import RescueConfig


class OracleRescueSponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the Rescue-Prime permutation."""

    def __init__(self, cfg: RescueConfig):
        super().__init__(cfg)

    def permute(self):
        cfg, f = self.cfg, self.f
        p = f.p
        state = list(self.state)
        for rc_row, e in zip(cfg.rc, [cfg.alpha, cfg.inv_alpha] * cfg.rounds):
            state = [f.pow(x, e) for x in state]
            state = [
                (sum(m * x for m, x in zip(row, state)) + c) % p
                for row, c in zip(cfg.mds, rc_row)
            ]
        self.state = state
