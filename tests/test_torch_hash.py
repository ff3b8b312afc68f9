"""The port's 2-to-1 compression, fixed-length hash and Merkle root against
the oracle sponge (BLS12-381 Fr) and ``sponge_tpu.hash`` (tiny field)."""

import jax.numpy as jnp
import numpy as np
import pytest
from conftest import TINY_FR, tiny_poseidon_config

import sponge_tpu.hash as jhash
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.hash import compress_pairs, hash_elements, merkle_root
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge

CFG = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)


def oracle_hash(cfg, elems, n=1):
    o = OraclePoseidonSponge(cfg)
    o.absorb_field_elements(list(elems))
    return o.squeeze_native_field_elements(n)


def rand(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 2**63)) ** 4 % p for _ in range(n)]


def test_merkle_root_matches_oracle_bls():
    fs = CFG.field
    leaves = rand(fs.modulus, 64, 0)
    leaves[:4] = [0, 1, fs.modulus - 1, fs.modulus - 2]
    plane = ints_to_mont_tensor(fs, leaves, "cpu")
    level = leaves
    while len(level) > 1:
        level = [oracle_hash(CFG, level[i : i + 2])[0] for i in range(0, len(level), 2)]
    root = merkle_root(CFG, plane)
    assert root.shape == (fs.nlimbs,)
    assert mont_tensor_to_ints(fs, root[:, None]) == level
    pairs = compress_pairs(CFG, plane[:, 0::2], plane[:, 1::2])
    assert mont_tensor_to_ints(fs, pairs) == [
        oracle_hash(CFG, leaves[i : i + 2])[0] for i in range(0, 64, 2)
    ]


@pytest.mark.parametrize("k,n", [(1, 1), (3, 2), (4, 5)])
def test_hash_elements_matches_oracle(k, n):
    cfg = interop.config_from_jax(tiny_poseidon_config())
    fs = cfg.field
    cols = [rand(fs.modulus, 4, 10 + i) for i in range(k)]
    out = hash_elements(cfg, ints_to_mont_tensor(fs, cols, "cpu"), n)
    assert out.shape == (n, fs.nlimbs, 4)
    got = mont_tensor_to_ints(fs, out)
    for b in range(4):
        assert [got[j][b] for j in range(n)] == oracle_hash(cfg, [c[b] for c in cols], n)


def test_merkle_root_matches_jax_tiny():
    jcfg = tiny_poseidon_config()
    cfg = interop.config_from_jax(jcfg)
    leaves = rand(TINY_FR.modulus, 32, 1)
    want = jhash.merkle_root(jcfg, jnp.asarray(TINY_FR.ints_to_mont_plane(leaves)))
    root = merkle_root(cfg, ints_to_mont_tensor(cfg.field, leaves, "cpu"))
    assert mont_tensor_to_ints(cfg.field, root[:, None]) == TINY_FR.mont_plane_to_ints(
        np.asarray(want)[:, None]
    )
    with pytest.raises(ValueError):
        merkle_root(cfg, ints_to_mont_tensor(cfg.field, leaves[:24], "cpu"))
