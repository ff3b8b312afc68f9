"""The probe kernels' plain versions (``ops/probe.py``) against Python-int
replays: the 32-bit and widening multiply-add chains with their 2^32 and
2^64 wraparound (products in [2^31, 2^32) and widening products above
2^47 included), the chains of Montgomery products at BLS12-381 width, and
kernel 1's schedule cut to nested prefixes.  Inputs come from numpy seeds;
equality is exact.  The CUDA kernels themselves run on the card
(``chip_smoke.py``'s probe phase).
"""

import numpy as np
import pytest
import torch

import sponge_tpu_torch as st
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build, probe

MUL, ADD = 0xF00DBEEF, 0x1234567
M32, M64 = (1 << 32) - 1, (1 << 64) - 1


def words(chains, w, B, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, size=(chains, w, B)).astype(np.int32)
    x[0, :, :3] = np.array([0, -1, -(2**31)], dtype=np.int32)  # 0, 2^32 - 1, 2^31
    return torch.from_numpy(x)


def replay(op, x, steps):
    """One lane's chain in Python ints (``wide``: the multiplicand is the
    high word at the start of each unrolled loop body, the multiplier of
    step u is MUL + u ADD)."""
    for i in range(steps):
        if op == "mul":
            x = x * MUL & M32
        elif op == "mad":
            x = (x * MUL + ADD) & M32
        elif op == "add":
            x = (x + MUL) & M32
        else:
            u = i % probe.UNROLL
            hi = x >> 32 if u == 0 else hi
            x = (x + hi * ((MUL + u * ADD) & M32)) & M64
    return x


@pytest.mark.parametrize("op", ["mul", "mad", "add", "wide"])
def test_chains_plain_matches_python_ints(op):
    w, iters = probe.WORDS[op], 2
    x = words(3, w, 16, 1)
    out = probe.probe_chains(op, torch.from_numpy(probe.chain_constants(op, MUL, ADD)), x, iters)
    assert out.dtype == torch.int32 and out.shape == x.shape
    u = x.numpy().astype(np.int64) & M32
    got = out.numpy().astype(np.int64) & M32
    steps = probe.chain_steps(op, iters)
    for c in range(3):
        for b in range(16):
            value = int(u[c, 0, b]) | (int(u[c, 1, b]) << 32 if w == 2 else 0)
            want = replay(op, value, steps)
            assert int(got[c, 0, b]) | (int(got[c, 1, b]) << 32 if w == 2 else 0) == want, (c, b)
    first = u[:, -1] * MUL  # the first product of each lane (of the high word for wide)
    if op == "mul":
        assert ((first & M32) >= 1 << 31).any()
    if op == "wide":
        assert (first >= 1 << 47).any() and (first >> 32 > 0).any()


@pytest.mark.parametrize("chains", [1, 2])
def test_mont11_chain_plain_matches_python_ints(chains):
    fs = st.BLS12_381_FR
    rng = np.random.default_rng(chains)
    vals = [[int(rng.integers(0, 2**62)) ** 5 % fs.modulus for _ in range(5)] for _ in range(chains)]
    vals[0][:2] = [0, fs.modulus - 1]
    c, iters = 0x1234567890ABCDEF, 64 // chains
    out = probe.probe_chains("mont11", torch.from_numpy(probe.chain_constants("mont11", c)),
                             ints_to_mont_tensor(fs, vals, "cpu"), iters)
    assert mont_tensor_to_ints(fs, out) == [[v * pow(c, iters, fs.modulus) % fs.modulus for v in row] for row in vals]


@pytest.mark.parametrize("mode", list(probe.ABLATION_MODES))
def test_ablation_plain_matches_python_ints(mode):
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    fs, p = cfg.field, cfg.field.modulus
    rng = np.random.default_rng(5)
    vals = [[int(rng.integers(0, 2**62)) ** 5 % p for _ in range(2)] for _ in range(cfg.t)]
    out = probe.probe_ablation(cfg, mode, torch.from_numpy(probe.ablation_constants(cfg)),
                               ints_to_mont_tensor(fs, vals, "cpu"))
    half = cfg.full_rounds // 2
    want = [list(row) for row in vals]
    for r in range(cfg.rounds if mode != "copy" else 0):
        full = r < half or r >= half + cfg.partial_rounds
        for e in range(cfg.t):
            want[e] = [(v + cfg.ark[r][e]) % p for v in want[e]]
            if mode == "pow" and (full or e == 0):
                want[e] = [pow(v, cfg.alpha, p) for v in want[e]]
    assert mont_tensor_to_ints(fs, out) == want
    assert probe.check_ablation_bounds(cfg) < 45 * p  # 33p: far below R = 565p


def test_probe_dispatch_on_cpu():
    consts = torch.from_numpy(probe.chain_constants("mul", MUL))
    x = words(4, 1, 8, 2)
    assert torch.equal(probe.probe_chains("mul", consts, x, 1), probe.chains_plain("mul", consts, x, 1))
    with pytest.raises(ValueError, match="unknown probe op"):
        probe.probe_chains("div", consts, x, 1)
    with pytest.raises(ValueError, match="plane"):
        probe.probe_chains("wide", consts, x, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        probe.probe_chains("mul", consts.to("meta"), x.to("meta"), 1)
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    with pytest.raises(ValueError, match="unknown ablation mode"):
        probe.probe_ablation(cfg, "mds", consts, x)
    for t, L in _build.INSTANTIATIONS["sponge_probe_chains"]:
        _build.check_instantiated("sponge_probe_chains", t, L)
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_probe_chains", 3, 1)
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_probe_ablation", 3, 2)
