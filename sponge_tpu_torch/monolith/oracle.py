"""Scalar python-int Monolith duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/monolith/oracle.py``: the duplex state machine is
``OraclePoseidonSponge``'s; only the permutation differs (Concrete, then R
rounds of Bars -> Bricks -> Concrete -> + rc, the last rc row zero).
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import bar_int


class OracleMonolithSponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the Monolith permutation
    (``cfg``: a ``MonolithConfig``)."""

    def _concrete(self, state):
        p = self.f.p
        return [sum(c * x for c, x in zip(row, state)) % p for row in self.cfg.concrete]

    def permute(self):
        cfg, p = self.cfg, self.f.p
        state = self._concrete(self.state)
        for r in range(cfg.rounds):
            state = [bar_int(cfg.field, x) if i < cfg.bars else x for i, x in enumerate(state)]
            # Bricks square the values before the update (a parallel Feistel).
            state = state[:1] + [(state[i] + state[i - 1] * state[i - 1]) % p for i in range(1, len(state))]
            state = [(x + c) % p for x, c in zip(self._concrete(state), cfg.rc[r])]
        self.state = state
