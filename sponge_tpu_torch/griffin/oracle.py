"""Scalar python-int Griffin-pi duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/griffin/oracle.py``: the duplex state machine is
``OraclePoseidonSponge``'s; only the permutation differs.
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import GriffinConfig


class OracleGriffinSponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the Griffin-pi permutation."""

    def __init__(self, cfg: GriffinConfig):
        super().__init__(cfg)

    def _apply_mat(self, state):
        p = self.f.p
        return [sum(e * x for e, x in zip(row, state)) % p for row in self.cfg.mat_e]

    def _nonlinear(self, state):
        """The Griffin S layer (griffin/config.py)."""
        cfg, p = self.cfg, self.f.p
        y0 = pow(state[0], cfg.inv_alpha, p)
        y1 = pow(state[1], cfg.alpha, p)
        out = [y0, y1]
        for i in range(2, len(state)):
            li = ((i - 1) * y0 + y1 + (state[i - 1] if i >= 3 else 0)) % p
            a_i, b_i = cfg.quad_coeffs(i)
            out.append(state[i] * (li * li + a_i * li + b_i) % p)
        return out

    def permute(self):
        cfg, p = self.cfg, self.f.p
        state = self._apply_mat(self.state)  # the opening linear layer
        for r in range(cfg.rounds):
            state = self._apply_mat(self._nonlinear(state))
            if r < cfg.rounds - 1:
                state = [(x + c) % p for x, c in zip(state, cfg.rc[r])]
        self.state = state
