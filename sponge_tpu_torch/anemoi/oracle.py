"""Scalar python-int Anemoi duplex sponge (ground truth of the port).

Counterpart of ``sponge_tpu/anemoi/oracle.py``: the duplex state machine is
``OraclePoseidonSponge``'s; only the permutation differs.
"""

from __future__ import annotations

from ..poseidon.oracle import OraclePoseidonSponge
from .config import AnemoiConfig


class OracleAnemoiSponge(OraclePoseidonSponge):
    """Reference-exact duplex sponge over the Anemoi permutation."""

    def __init__(self, cfg: AnemoiConfig):
        super().__init__(cfg)

    def _diffusion(self, xs, ys):
        """M_x on X, M_x on rot-left-1(Y), then the PHT."""
        p, m = self.f.p, self.cfg.mat_x
        xs = [sum(e * x for e, x in zip(row, xs)) % p for row in m]
        ys = [sum(e * y for e, y in zip(row, ys[1:] + ys[:1])) % p for row in m]
        ys = [(y + x) % p for x, y in zip(xs, ys)]
        xs = [(x + y) % p for x, y in zip(xs, ys)]
        return xs, ys

    def _flystel(self, x, y):
        """The open Flystel (anemoi/config.py)."""
        cfg, p = self.cfg, self.f.p
        u = (x - (cfg.g * y * y + cfg.g_inv)) % p
        v = (y - pow(u, cfg.inv_alpha, p)) % p
        return (u + cfg.g * v * v) % p, v

    def permute(self):
        cfg, p, lcol = self.cfg, self.f.p, self.cfg.l
        xs, ys = list(self.state[:lcol]), list(self.state[lcol:])
        for cx, cy in zip(cfg.rc_x, cfg.rc_y):
            xs = [(x + c) % p for x, c in zip(xs, cx)]
            ys = [(y + c) % p for y, c in zip(ys, cy)]
            xs, ys = self._diffusion(xs, ys)
            xs, ys = map(list, zip(*(self._flystel(x, y) for x, y in zip(xs, ys))))
        xs, ys = self._diffusion(xs, ys)  # the closing linear layer
        self.state = xs + ys
