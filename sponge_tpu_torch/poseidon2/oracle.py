"""Scalar python-int Poseidon2 duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/poseidon2/oracle.py``: the duplex state machine
is ``OraclePoseidonSponge``'s; only the permutation differs.
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import Poseidon2Config


class OraclePoseidon2Sponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the Poseidon2 permutation."""

    def __init__(self, cfg: Poseidon2Config):
        super().__init__(cfg)

    def _external(self, state):
        p = self.f.p
        return [sum(e * x for e, x in zip(row, state)) % p for row in self.cfg.mat_e]

    def _internal(self, state):
        # M_I = J + diag(mu - 1): out_i = sum_j x_j + (mu_i - 1) x_i.
        p = self.f.p
        sigma = sum(state)
        return [(sigma + (mu - 1) * x) % p for mu, x in zip(self.cfg.mat_i_diag, state)]

    def _external_round(self, state, r):
        cfg, f = self.cfg, self.f
        state = [f.pow(f.add(x, c), cfg.alpha) for x, c in zip(state, cfg.external_rc[r])]
        return self._external(state)

    def permute(self):
        cfg, f = self.cfg, self.f
        half = cfg.full_rounds // 2
        state = self._external(list(self.state))  # initial linear layer
        for r in range(half):
            state = self._external_round(state, r)
        for c in cfg.internal_rc:
            state[0] = f.pow(f.add(state[0], c), cfg.alpha)
            state = self._internal(state)
        for r in range(half, cfg.full_rounds):
            state = self._external_round(state, r)
        self.state = state
