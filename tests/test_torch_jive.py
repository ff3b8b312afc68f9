"""The port's Jive-mode Merkle trees (``hash.py``: ``jive_compress_pairs``,
``merkle_tree_jive`` / ``merkle_root_jive``, proofs through
``merkle_open_batch_wide`` and ``merkle_verify_batch_jive``) against
``sponge_tpu.hash`` on the same planes, and against a Python-int replay of
the oracle permutation plus the four-term sum over Griffin Goldilocks t = 8.

The JAX side runs the conftest's 35-bit Poseidon config at t = 4 (d = 2),
computed once for the module.  Equality is exact on canonical values: the
JAX package leaves a Jive digest below 2p, the port reduces it below p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_poseidon_config

import sponge_tpu.hash as jhash
import sponge_tpu_torch as st
from sponge_tpu_torch import hash as h
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, limbs_to_ints, mont_tensor_to_ints

JCFG = tiny_poseidon_config(t=4)
CFG = interop.config_from_jax(JCFG)
JFS, FS = JCFG.field, CFG.field
P = FS.modulus
D = 2
N = 8
INDICES = [0, 3, 5, 7]


def canonical(jplane):
    """A JAX Montgomery plane (possibly below 2p) as canonical ints."""
    return interop.jax_limbs_to_ints(np.asarray(jplane), P, JFS.limb_bits).tolist()


def port_ints(plane):
    return [mont_tensor_to_ints(FS, row) for row in plane] if plane.dim() == 3 else mont_tensor_to_ints(FS, plane)


def planes(vals):
    """(d, B) ints -> (JAX plane, port plane)."""
    return (jnp.asarray(np.stack([JFS.ints_to_mont_plane(row) for row in vals])),
            ints_to_mont_tensor(FS, vals, "cpu"))


def random_vals(seed, d, n, p=P):
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, 2**63)) % p for _ in range(n)] for _ in range(d)]


@pytest.fixture(scope="module")
def ref():
    """Every JAX result of the module, computed once."""
    left = random_vals(1, D, 16)
    right = random_vals(2, D, 16)
    edges = [0, 1, P - 1, P - 2]
    for e in range(D):  # 0, 1, p-1, p-2 in every element position of lanes 0..15
        for b in range(16):
            left[e][b] = edges[(b >> (2 * e)) & 3]
            right[e][b] = edges[(b + e) & 3]
    full = [[P - 1] * 4 for _ in range(D)]
    jl, tl = planes(left)
    jr, tr = planes(right)
    jfull, tfull = planes(full)
    leaves = random_vals(3, D, N)
    jleaves, tleaves = planes(leaves)
    jlevels = jhash.merkle_tree_jive(JCFG, jleaves)
    jroot = jlevels[-1][..., 0]  # merkle_root_jive runs the same level loop
    jpaths = jhash.merkle_open_batch_wide(jlevels, INDICES)
    jok = jhash.merkle_verify_batch_jive(JCFG, jroot, jleaves[..., INDICES], jpaths, INDICES)
    return dict(
        left=tl, right=tr, full=tfull, leaves=tleaves,
        pairs=canonical(jhash.jive_compress_pairs(JCFG, jl, jr)),
        full_out=np.asarray(jhash.jive_compress_pairs(JCFG, jfull, jfull)),
        levels=[canonical(level) for level in jlevels], root=[r[0] for r in canonical(jroot[..., None])],
        paths=canonical(jpaths), ok=np.asarray(jok).tolist(),
    )


def test_compress_matches_jax_with_edge_lanes(ref):
    out = h.jive_compress_pairs(CFG, ref["left"], ref["right"])
    assert out.shape == ref["left"].shape and out.dtype == torch.int32
    assert port_ints(out) == ref["pairs"]


def test_compress_output_is_canonical(ref):
    """All-(p-1) inputs: the port's digest is below p as it stands, and
    equal mod p to the JAX package's, which need only be below 2p."""
    out = h.jive_compress_pairs(CFG, ref["full"], ref["full"])
    raw = [limbs_to_ints(FS, row) for row in out.numpy()]
    assert all(v < P for row in raw for v in row)
    jraw = interop.jax_limbs_to_ints(ref["full_out"], P, JFS.limb_bits).tolist()
    assert port_ints(out) == jraw
    jmont = [[sum(int(x) << (JFS.limb_bits * k) for k, x in enumerate(col)) for col in row.T]
             for row in ref["full_out"]]
    assert all(v < 2 * P for row in jmont for v in row)


def test_compress_needs_t_twice_the_digest(ref):
    with pytest.raises(ValueError, match="Jive_2"):
        h.jive_compress_pairs(CFG, ref["left"][:1], ref["right"][:1])


def test_tree_and_root_match_jax(ref):
    levels = h.merkle_tree_jive(CFG, ref["leaves"])
    assert [tuple(level.shape) for level in levels] == [(D, FS.nlimbs, N >> i) for i in range(4)]
    assert [port_ints(level) for level in levels] == ref["levels"]
    root = h.merkle_root_jive(CFG, ref["leaves"])
    assert torch.equal(root, levels[-1][..., 0])
    assert [mont_tensor_to_ints(FS, row[:, None])[0] for row in root] == ref["root"]
    with pytest.raises(ValueError, match="power of two"):
        h.merkle_root_jive(CFG, ref["leaves"][..., :6])


def test_open_and_verify_match_jax(ref):
    levels = h.merkle_tree_jive(CFG, ref["leaves"])
    root = levels[-1][..., 0]
    paths = h.merkle_open_batch_wide(levels, INDICES)
    assert paths.shape == (3, D, FS.nlimbs, len(INDICES))
    assert [port_ints(p) for p in paths] == ref["paths"]
    ok = h.merkle_verify_batch_jive(CFG, root, ref["leaves"][..., INDICES], paths, INDICES)
    assert ok.tolist() == ref["ok"] == [True] * len(INDICES)


def test_tampered_lanes_fail_alone(ref):
    """A wrong leaf, a wrong sibling and a wrong index each fail only their
    own proof; an index past the tree raises."""
    levels = h.merkle_tree_jive(CFG, ref["leaves"])
    root = levels[-1][..., 0]
    paths = h.merkle_open_batch_wide(levels, INDICES)
    leaves = ref["leaves"][..., INDICES].clone()
    leaves[..., 1] = ref["leaves"][..., 4]
    assert h.merkle_verify_batch_jive(CFG, root, leaves, paths, INDICES).tolist() == [True, False, True, True]
    bad_paths = paths.clone()
    bad_paths[2, :, :, 2] = ref["leaves"][..., 0]
    assert h.merkle_verify_batch_jive(CFG, root, ref["leaves"][..., INDICES], bad_paths, INDICES).tolist() == [
        True, True, False, True]
    bad_idx = [0, 3, 5, 6]
    assert h.merkle_verify_batch_jive(CFG, root, ref["leaves"][..., INDICES], paths, bad_idx).tolist() == [
        True, True, True, False]
    with pytest.raises(IndexError):
        h.merkle_verify_batch_jive(CFG, root, ref["leaves"][..., INDICES], paths, [0, 3, 5, 8])


def test_sponge_mode_verifier_refuses_jive_proofs(ref):
    levels = h.merkle_tree_jive(CFG, ref["leaves"])
    paths = h.merkle_open_batch_wide(levels, INDICES)
    ok = h.merkle_verify_batch_wide(CFG, levels[-1][..., 0], ref["leaves"][..., INDICES], paths, INDICES)
    assert not ok.any()


def jive_oracle(cfg, left, right):
    """One Jive_2 node by the oracle permutation on Python ints."""
    x = list(left) + list(right)
    o = cfg.oracle_sponge()
    o.state = list(x)
    o.permute()
    d, p = len(left), cfg.field.modulus
    return [(x[j] + x[d + j] + o.state[j] + o.state[d + j]) % p for j in range(d)]


def test_griffin_goldilocks_node_and_root_match_oracle():
    """Griffin-pi over Goldilocks at t = 8 (d = 4): every node of a 4-leaf
    tree equals the oracle replay, edge values included."""
    cfg = st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4)
    fs = cfg.field
    assert cfg.t == 8
    vals = random_vals(4, 4, 4, fs.modulus)
    vals[0][:4] = [0, 1, fs.modulus - 1, fs.modulus - 2]
    vals[3][1] = fs.modulus - 1
    leaves = ints_to_mont_tensor(fs, vals, "cpu")
    cols = [[vals[e][i] for e in range(4)] for i in range(4)]
    n01, n23 = jive_oracle(cfg, cols[0], cols[1]), jive_oracle(cfg, cols[2], cols[3])
    node = h.jive_compress_pairs(cfg, leaves[..., 0:1], leaves[..., 1:2])
    assert [mont_tensor_to_ints(fs, row)[0] for row in node] == n01
    root = h.merkle_root_jive(cfg, leaves)
    assert [mont_tensor_to_ints(fs, row[:, None])[0] for row in root] == jive_oracle(cfg, n01, n23)
