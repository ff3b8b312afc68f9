"""The port's Merkle API (``hash.py``: narrow and wide-digest trees, batched
opening and verification) against ``sponge_tpu.hash`` on the same planes,
and against the oracle sponge over Monolith-64.

The JAX side runs the conftest's 35-bit Poseidon config (each of its jitted
trees and verifications compiles in a few seconds on the CPU); the wide
tree there uses d = 2 digests, three permutations per node at rate 2, and
the wide verification d = 1 over four leaves.  Planes cross with ``interop``; equality is
exact (tolerance 0) on canonical values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_poseidon_config

import sponge_tpu.hash as jhash
import sponge_tpu_torch as st
from sponge_tpu_torch import hash as h
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints

JCFG = tiny_poseidon_config()
CFG = interop.config_from_jax(JCFG)
JFS, FS = JCFG.field, CFG.field
N = 8  # leaves: depth 3
INDICES = [0, 5, 7, 6]


def leaf_values(d, seed):
    rng = np.random.default_rng(seed)
    vals = [[int(rng.integers(0, 2**62)) % FS.modulus for _ in range(N)] for _ in range(d)]
    vals[0][:4] = [0, 1, FS.modulus - 1, FS.modulus - 2]
    return vals


def to_port(plane):
    return interop.plane_from_jax(np.asarray(plane), FS, JFS.limb_bits, "cpu")


def jax_plane(vals):
    return jnp.asarray(np.stack([JFS.ints_to_mont_plane(row) for row in vals]))


def narrow(seed):
    vals = leaf_values(1, seed)[0]
    return jnp.asarray(JFS.ints_to_mont_plane(vals)), ints_to_mont_tensor(FS, vals, "cpu")


def wide(seed, n=N, d=2):
    vals = [row[:n] for row in leaf_values(d, seed)]
    return jax_plane(vals), ints_to_mont_tensor(FS, vals, "cpu")


def test_narrow_levels_and_paths_match_jax():
    jleaves, leaves = narrow(1)
    levels, jlevels = h.merkle_tree(CFG, leaves), jhash.merkle_tree(JCFG, jleaves)
    assert len(levels) == len(jlevels) == 4
    for got, want in zip(levels, jlevels):
        assert torch.equal(got, to_port(want))
    assert torch.equal(h.merkle_root(CFG, leaves), levels[-1][:, 0])
    paths = h.merkle_open_batch(levels, INDICES)
    assert paths.shape == (3, FS.nlimbs, len(INDICES))
    assert torch.equal(paths, to_port(jhash.merkle_open_batch(jlevels, INDICES)))
    for i in (0, 5, 7):
        assert torch.equal(torch.stack(h.merkle_open(levels, i)), paths[..., INDICES.index(i)] if i in INDICES
                           else h.merkle_open_batch(levels, [i])[..., 0])


def test_narrow_verify_matches_jax():
    """Honest proofs verify in both packages; a wrong sibling or a wrong leaf
    fails only its own proof."""
    jleaves, leaves = narrow(2)
    levels, jlevels = h.merkle_tree(CFG, leaves), jhash.merkle_tree(JCFG, jleaves)
    root, paths = levels[-1][:, 0], h.merkle_open_batch(levels, INDICES)
    jpaths = jhash.merkle_open_batch(jlevels, INDICES)
    ok = h.merkle_verify_batch(CFG, root, leaves[:, INDICES], paths, INDICES)
    jok = jhash.merkle_verify_batch(JCFG, jlevels[-1][:, 0], jleaves[:, INDICES], jpaths, INDICES)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * len(INDICES)
    bad = paths.clone()
    bad[2, :, 1] = leaves[:, 3]  # a canonical value that is not lane 1's sibling
    assert h.merkle_verify_batch(CFG, root, leaves[:, INDICES], bad, INDICES).tolist() == [True, False, True, True]
    for i in (0, 5, 7):
        path = h.merkle_open(levels, i)
        assert h.merkle_verify(CFG, root, leaves[:, i], path, i)
        assert not h.merkle_verify(CFG, root, leaves[:, i ^ 1], path, i)


def test_wide_levels_and_paths_match_jax():
    jleaves, leaves = wide(3)
    levels, jlevels = h.merkle_tree_wide(CFG, leaves), jhash.merkle_tree_wide(JCFG, jleaves)
    for got, want in zip(levels, jlevels):
        assert torch.equal(got, to_port(want))
    root = h.merkle_root_wide(CFG, leaves)
    assert torch.equal(root, levels[-1][..., 0]) and root.shape == (2, FS.nlimbs)
    paths = h.merkle_open_batch_wide(levels, INDICES)
    assert paths.shape == (3, 2, FS.nlimbs, len(INDICES))
    assert torch.equal(paths, to_port(jhash.merkle_open_batch_wide(jlevels, INDICES)))


def test_wide_verify_matches_jax():
    """Four one-element digests (the JAX package's batched verification
    compiles its whole depth): honest proofs verify in both; one wrong
    sibling fails its own.  The port's root and paths cross to the JAX
    side (the trees are compared in the test above)."""
    idx = [0, 3, 2]
    jleaves, leaves = wide(4, n=4, d=1)
    levels = h.merkle_tree_wide(CFG, leaves)
    root, paths = levels[-1][..., 0], h.merkle_open_batch_wide(levels, idx)
    ok = h.merkle_verify_batch_wide(CFG, root, leaves[..., idx], paths, idx)
    to_jax = lambda plane: jnp.asarray(interop.plane_to_jax(plane, FS, JFS.limb_bits, JFS.nlimbs))  # noqa: E731
    jok = jhash.merkle_verify_batch_wide(JCFG, to_jax(root[..., None])[..., 0], jleaves[..., idx], to_jax(paths), idx)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 3
    bad = paths.clone()
    bad[1, 0, :, 2] = leaves[0, :, 1]
    assert h.merkle_verify_batch_wide(CFG, root, leaves[..., idx], bad, idx).tolist() == [True, True, False]


def test_compress_digest_pairs_and_default_width():
    """d = ceil(256 / bits): 2 at BLS12-381 (255 bits), 4 at Goldilocks, 8
    at the 35-bit field; a digest pair is ``hash_elements`` of the 2d
    elements."""
    assert h.default_digest_elems(st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)) == 2
    assert h.default_digest_elems(st.get_default_monolith_parameters(st.GOLDILOCKS_FR)) == 4
    assert h.default_digest_elems(CFG) == jhash.default_digest_elems(JCFG) == 8
    left, right = (ints_to_mont_tensor(FS, leaf_values(3, s), "cpu") for s in (4, 5))
    got = h.compress_digest_pairs(CFG, left, right)
    want = jhash.compress_digest_pairs(JCFG, jax_plane(leaf_values(3, 4)), jax_plane(leaf_values(3, 5)))
    assert torch.equal(got, to_port(want))


def test_monolith_wide_root_matches_oracle():
    """Monolith-64 (t = 12, d = 4, one permutation per node) over 8 leaves
    against the oracle sponge."""
    cfg = st.get_default_monolith_parameters(st.GOLDILOCKS_FR)
    fs, d = cfg.field, 4
    rng = np.random.default_rng(6)
    vals = [[int(rng.integers(0, 2**63)) % fs.modulus for _ in range(8)] for _ in range(d)]
    root = h.merkle_root_wide(cfg, ints_to_mont_tensor(fs, vals, "cpu"))
    level = [[vals[e][i] for e in range(d)] for i in range(8)]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = st.OracleMonolithSponge(cfg)
            o.absorb_field_elements(level[i] + level[i + 1])
            nxt.append(o.squeeze_native_field_elements(d))
        level = nxt
    assert [v[0] for v in mont_tensor_to_ints(fs, root[..., None])] == level[0]


@pytest.mark.parametrize("case", ["tree-width", "open-index", "batch-index", "verify-index", "narrow-rate"])
def test_refusals(case):
    leaves = narrow(5)[1]
    levels = h.merkle_tree(CFG, leaves)
    if case == "narrow-rate":
        # the d = 1 views keep the 2-to-1 compression's refusal of rate 1
        rate1 = dataclasses.replace(CFG, rate=1, capacity=2)
        with pytest.raises(ValueError, match="rate >= 2"):
            h.merkle_tree(rate1, leaves)
        with pytest.raises(ValueError, match="rate >= 2"):
            h.merkle_verify_batch(rate1, levels[-1][:, 0], leaves[:, [3]], h.merkle_open_batch(levels, [3]), [3])
    elif case == "tree-width":
        with pytest.raises(ValueError, match="power of two"):
            h.merkle_tree_wide(CFG, leaves[None, :, :6])
    elif case == "open-index":
        with pytest.raises(IndexError):
            h.merkle_open(levels, N)
    elif case == "batch-index":
        with pytest.raises(IndexError):
            h.merkle_open_batch(levels, [0, -1])
    else:
        paths = h.merkle_open_batch(levels, [3])
        with pytest.raises(IndexError):
            h.merkle_verify_batch(CFG, levels[-1][:, 0], leaves[:, [3]], paths, [N])
