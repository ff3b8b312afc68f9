"""The probe kernels (``csrc/probe.cu``) and their plain PyTorch versions.

Counterparts of the JAX package's ``bench/`` probes, which measured the TPU's
vector unit (``latency_probe.py``, ``uint32_probe.py``,
``vpu_roofline_probe.py``, ``latency_accounting_probe.py``).  On the H100
they answer what the kernels' bounds rest on:

* ``probe_chains``: ``chains`` independent register chains per thread of one
  operation (``OPS``), timed by the caller at one chain (dependent latency)
  and at many (issue rate); ``mont11`` is the Montgomery product by a
  constant at BLS12-381 width, as one chain of 64 or two of 32.
* ``probe_ablation``: kernel 1's round schedule cut to nested prefixes
  (``ABLATION_MODES``): copy, round constants, the S-boxes (kernel 1's own
  ``pow_sqr``), the full rounds' MDS; kernel 1 itself adds the sparse
  phase.

Each plain version replays the same arithmetic with int64 tensor ops: the
32-bit chains with explicit 2^32 and 2^64 masking (products split at 16 bits
so no int64 product overflows), the Montgomery chains and the ablation with
the plain Montgomery tier.  A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import BLS12_381_FR
from ..poseidon.config import PoseidonConfig, mont_limb_rows
from . import _build
from . import montgomery as mont
from .bounds import _Replay

OPS = {"mul": 0, "mad": 1, "add": 2, "wide": 3, "mont11": 4}
WORDS = {"mul": 1, "mad": 1, "add": 1, "wide": 2, "mont11": 11}
UNROLL = 16  # steps per loop iteration of the 32-bit chains (csrc/probe.cu kUnroll)
ABLATION_MODES = {"copy": 0, "ark": 1, "pow": 2, "full_mds": 3}
_M16, _M32 = (1 << 16) - 1, (1 << 32) - 1


def chain_steps(op: str, iters: int) -> int:
    """Steps each chain takes: ``iters`` Montgomery products, or ``iters``
    loop iterations of ``UNROLL`` 32-bit operations."""
    return iters if op == "mont11" else iters * UNROLL


def chain_constants(op: str, mul: int, add: int = 0) -> np.ndarray:
    """The chains' constant buffer: the multiplier and the addend as 32-bit
    patterns (for ``wide`` the addend is the step between the multipliers
    of the unrolled steps), or for ``mont11`` BLS12-381's modulus and the
    Montgomery limbs of ``mul``."""
    if op == "mont11":
        fs = BLS12_381_FR
        return np.concatenate([fs.int_to_limbs(fs.modulus), mont_limb_rows(fs, [[mul % fs.modulus]])[0, 0]]).astype(np.int32)
    return np.asarray([mul, add], dtype=np.uint32).view(np.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """32-bit patterns (int64 below 2^32) -> the int32 tensor holding them."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).int()


def _mul_lo(a: torch.Tensor, m: int) -> torch.Tensor:
    """a * m mod 2^32 for a, m below 2^32, with every product below 2^48."""
    return (a * (m & _M16) + (((a * (m >> 16)) & _M16) << 16)) & _M32


def chains_plain(op: str, consts: torch.Tensor, state: torch.Tensor, iters: int) -> torch.Tensor:
    """The chains of ``probe_chains`` with int64 tensor ops."""
    steps = chain_steps(op, iters)
    if op == "mont11":
        fs = BLS12_381_FR
        c = consts[fs.nlimbs :].long()[:, None]
        x = state.long()
        for _ in range(steps):
            x = mont.mont_mul(fs, x, c)
        return x.int()
    mul, add = (int(v) & _M32 for v in consts[:2].tolist())
    if op == "wide":
        lo, hi = _u32(state[:, 0]), _u32(state[:, 1])
        for i in range(steps):
            u = i % UNROLL
            if u == 0:
                x = hi
            m = (mul + u * add) & _M32
            p0, p1 = x * (m & _M16), x * (m >> 16)  # x * m = p0 + p1 2^16
            lo = lo + (p0 & _M32) + ((p1 & _M16) << 16)
            hi = (hi + (p0 >> 32) + (p1 >> 16) + (lo >> 32)) & _M32
            lo = lo & _M32
        return _i32(torch.stack([lo, hi], 1))
    a = _u32(state[:, 0])
    for _ in range(steps):
        if op == "add":
            a = (a + mul) & _M32
        else:
            a = (_mul_lo(a, mul) + (add if op == "mad" else 0)) & _M32
    return _i32(a[:, None])


def probe_chains(op: str, consts: torch.Tensor, state: torch.Tensor, iters: int, clocks=None) -> torch.Tensor:
    """``chains`` = state.shape[0] register chains per lane of ``op`` over a
    (chains, WORDS[op], B) int32 plane, ``chain_steps(op, iters)`` steps
    each.  ``clocks``, a CUDA int64 tensor of 2, receives thread 0's SM
    cycles and nanoseconds."""
    if op not in OPS:
        raise ValueError(f"unknown probe op {op!r}; one of {tuple(OPS)}")
    if state.dim() != 3 or state.shape[1] != WORDS[op] or state.dtype != torch.int32:
        raise ValueError(f"{op} chains take a (chains, {WORDS[op]}, B) int32 plane")
    if not state.is_contiguous() or consts.device != state.device:
        raise ValueError("the plane must be contiguous and on the constants' device")
    if state.device.type == "cpu":
        return chains_plain(op, consts, state, iters)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    _build.check_instantiated("sponge_probe_chains", state.shape[0], WORDS[op])
    out = torch.empty_like(state)
    clk = None if clocks is None else clocks.data_ptr()
    _build.launch("sponge_probe_chains", state, out, OPS[op], iters, consts.data_ptr(), clk, BLS12_381_FR.n0inv)
    probe_chains.launches += 1
    return out


probe_chains.launches = 0


def ablation_constants(cfg: PoseidonConfig) -> np.ndarray:
    """p (L) | R mod p (L) | ark (rounds, t, L) | mds (t, t, L): plain,
    plain, Montgomery, Montgomery."""
    fs = cfg.field
    parts = [
        fs.int_to_limbs(fs.modulus), fs.int_to_limbs(fs.r_mod_p), mont_limb_rows(fs, cfg.ark),
        mont_limb_rows(fs, cfg.mds),
    ]
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def check_ablation_bounds(cfg: PoseidonConfig) -> int:
    """Replay the ``pow`` and ``full_mds`` prefixes on value bounds: every
    round adds its constants to every element, full rounds raise all t
    elements to alpha (``full_mds``: then the MDS rows, one REDC each),
    partial rounds element 0, then the exit product by 1.  Raises
    ValueError if a value could reach R or the output 2p; returns the
    largest value bound."""
    fs = cfg.field
    sim = _Replay(f"kernel 1 ablation, {fs.name} t={cfg.t}", fs, terms=cfg.t)
    half = cfg.full_rounds // 2
    for mds in (False, True):
        xs = [sim.const] * cfg.t
        for r in range(cfg.rounds):
            full = r < half or r >= half + cfg.partial_rounds
            xs = [sim.add(x, sim.const) for x in xs]
            xs = [sim.pow(x, cfg.alpha) if full or e == 0 else x for e, x in enumerate(xs)]
            if full and mds:
                xs = [sim.row(xs) for _ in xs]
        for x in xs:
            sim.exit(x)
    return sim.vmax


def ablation_plain(cfg: PoseidonConfig, mode: str, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The prefix ``mode`` of kernel 1's schedule with the plain Montgomery
    tier (canonical after every step)."""
    fs, t = cfg.field, cfg.t
    if ABLATION_MODES[mode] == 0:
        return state.clone()
    L = fs.nlimbs
    ark = consts[2 * L : 2 * L + cfg.rounds * t * L].long().reshape(cfg.rounds, t, L, 1)
    mds = consts[2 * L + cfg.rounds * t * L :].long().reshape(t, t, L, 1)
    half = cfg.full_rounds // 2
    x = state.long()
    for r in range(cfg.rounds):
        x = mont.mont_add(fs, x, ark[r])
        if ABLATION_MODES[mode] >= 2:
            full = r < half or r >= half + cfg.partial_rounds
            n = t if full else 1
            x = torch.cat([mont.mont_pow(fs, x[:n], cfg.alpha), x[n:]])
            if full and mode == "full_mds":
                x = mont.mont_dot(fs, mds, x)
    return x.int()


def probe_ablation(cfg: PoseidonConfig, mode: str, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The prefix ``mode`` of kernel 1 over a (t, L, B) canonical plane;
    ``consts`` is ``ablation_constants(cfg)`` on the state's device."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of {tuple(ABLATION_MODES)}")
    fs = cfg.field
    if tuple(state.shape[:2]) != (cfg.t, fs.nlimbs) or state.dtype != torch.int32 or not state.is_contiguous():
        raise ValueError(f"the ablation takes a contiguous (t, L, B) = ({cfg.t}, {fs.nlimbs}, B) int32 plane")
    if consts.device != state.device:
        raise ValueError(f"constants on {consts.device}, state on {state.device}")
    if state.device.type == "cpu":
        return ablation_plain(cfg, mode, consts, state)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    _build.check_instantiated("sponge_probe_ablation", cfg.t, fs.nlimbs)
    check_ablation_bounds(cfg)
    out = torch.empty_like(state)
    _build.launch(
        "sponge_probe_ablation", state, out, ABLATION_MODES[mode], cfg.alpha, cfg.full_rounds,
        cfg.partial_rounds, consts.data_ptr(), fs.n0inv,
    )
    probe_ablation.launches += 1
    return out


probe_ablation.launches = 0
