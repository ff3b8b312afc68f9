"""The port's plain Montgomery tier against ``sponge_tpu.ops.montgomery``.

The same numpy-seeded inputs go through both packages' ``mont_mul``,
``mont_add``, ``mont_pow`` and ``from_mont`` (each in its own limb plan) and
the results are compared as canonical ints, exactly.  The port's outputs
must also be canonical limb planes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import TINY_FR

import sponge_tpu
from sponge_tpu.ops import montgomery as jmont
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, limbs_to_ints, mont_tensor_to_ints
from sponge_tpu_torch.ops import montgomery as mont

FIELDS = [TINY_FR, sponge_tpu.BLS12_381_FR]
B = 48


def inputs(jfs, seed):
    rng = np.random.default_rng(seed)
    p = jfs.modulus
    edge = [0, 1, p - 1, p - 2]
    xs = edge + [int(rng.integers(0, 2**63)) ** 4 % p for _ in range(B - 4)]
    ys = edge[::-1] + [int(rng.integers(0, 2**63)) ** 3 % p for _ in range(B - 4)]
    return xs, ys


def both(jfs, vals):
    """(JAX plane, port tensor, port field) of one value list."""
    fs = interop.field_for_modulus(jfs.modulus)
    return jnp.asarray(jfs.ints_to_mont_plane(vals)), ints_to_mont_tensor(fs, vals, "cpu"), fs


def jit(fn, *static, **kw):
    """The JAX function jitted over its array arguments (eager dispatch of the
    unrolled 22-limb arithmetic is several times slower than compiling it)."""
    return jax.jit(functools.partial(fn, *static, **kw))


def port_ints(fs, out):
    assert out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < 1 << 24
    vals = limbs_to_ints(fs, out.numpy())
    assert all(v < fs.modulus for v in vals)  # canonical
    return [fs.from_mont(v) for v in vals]


@pytest.mark.parametrize("jfs", FIELDS, ids=lambda f: f.name)
def test_mont_mul_and_add_match_jax(jfs):
    xs, ys = inputs(jfs, 0)
    jx, tx, fs = both(jfs, xs)
    jy, ty, _ = both(jfs, ys)
    p = jfs.modulus
    want_mul = jfs.mont_plane_to_ints(np.asarray(jit(jmont.mont_mul, jfs)(jx, jy)))
    assert want_mul == [x * y % p for x, y in zip(xs, ys)]
    assert port_ints(fs, mont.mont_mul(fs, tx, ty)) == want_mul
    want_add = jfs.mont_plane_to_ints(np.asarray(jit(jmont.mont_add, jfs)(jx, jy)))
    assert port_ints(fs, mont.mont_add(fs, tx, ty)) == want_add


@pytest.mark.parametrize("alpha", [5, 17])
@pytest.mark.parametrize("jfs", FIELDS, ids=lambda f: f.name)
def test_mont_pow_matches_jax(jfs, alpha):
    xs, _ = inputs(jfs, 1)
    jx, tx, fs = both(jfs, xs)
    want = jfs.mont_plane_to_ints(np.asarray(jit(jmont.mont_pow, jfs, alpha=alpha)(jx)))
    assert want == [pow(x, alpha, jfs.modulus) for x in xs]
    assert port_ints(fs, mont.mont_pow(fs, tx, alpha)) == want


@pytest.mark.parametrize("jfs", FIELDS, ids=lambda f: f.name)
def test_from_mont_and_to_mont_match_jax(jfs):
    xs, _ = inputs(jfs, 2)
    jx, tx, fs = both(jfs, xs)
    jplain = np.asarray(jit(jmont.from_mont, jfs)(jx))
    want = [jfs.limbs_to_int(jplain[:, b]) for b in range(B)]
    plain = mont.from_mont(fs, tx)
    assert limbs_to_ints(fs, plain.numpy()) == want == xs
    assert mont_tensor_to_ints(fs, mont.to_mont(fs, plain)) == xs


def test_mont_dot_lazy_row_sum():
    """One REDC over a row's summed products equals the field dot product."""
    jfs = sponge_tpu.BLS12_381_FR
    fs = interop.field_for_modulus(jfs.modulus)
    rng = np.random.default_rng(3)
    p = fs.modulus
    mat = [[int(rng.integers(0, 2**62)) ** 5 % p for _ in range(3)] for _ in range(2)]
    vecs = [inputs(jfs, 10 + j)[0] for j in range(3)]
    c = ints_to_mont_tensor(fs, [v for row in mat for v in row], "cpu").reshape(fs.nlimbs, 2, 3)
    c = c.permute(1, 2, 0)[..., None]  # (2, 3, L, 1)
    x = ints_to_mont_tensor(fs, vecs, "cpu")  # (3, L, B)
    out = mont.mont_dot(fs, c, x)
    for i in range(2):
        want = [sum(mat[i][j] * vecs[j][b] for j in range(3)) % p for b in range(B)]
        assert port_ints(fs, out[i]) == want


PRIMITIVE_FIELDS = {  # L = 2, 3, 11
    "tiny_fr_25": lambda: st.FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3),
    "goldilocks_fr": lambda: st.GOLDILOCKS_FR,
    "bls12_381_fr": lambda: st.BLS12_381_FR,
}


def _plane(fs, vals):
    """(L, B) int64 limbs of arbitrary non-negative ints below 2^(24 L)."""
    return torch.tensor([[(v >> (24 * k)) & 0xFFFFFF for v in vals] for k in range(fs.nlimbs)])


def _value(rows):
    """The ints of a (K, B) plane of limb columns of weight 2^(24 k)."""
    return [sum(int(rows[k, b]) << (24 * k) for k in range(rows.shape[0])) for b in range(rows.shape[1])]


@pytest.mark.parametrize("name", list(PRIMITIVE_FIELDS))
def test_plain_primitives_match_python_ints(name):
    """``carry``, ``columns``, ``redc`` and ``reduce_once`` against Python
    ints on edge limbs: every limb 0 or 2^24 - 1, values p - 1, p, 2p - 1 and
    R - 1, and a broadcast (n, L, 1) x (L, B) product as ``mont_dot`` forms
    it."""
    fs = PRIMITIVE_FIELDS[name]()
    p, R, L = fs.modulus, fs.r, fs.nlimbs
    rng = np.random.default_rng(L)
    edge = [0, 1, p - 1, p, 2 * p - 1, R - 1, sum(0xFFFFFF << (48 * k) for k in range((L + 1) // 2))]
    xs = edge + [int(rng.integers(0, 2**63)) ** 5 % R for _ in range(9)]
    ys = xs[::-1]
    a, b = _plane(fs, xs), _plane(fs, ys)
    cols = mont.columns(a, b)
    assert cols.shape == (2 * L, len(xs))
    for k in range(2 * L):
        assert cols[k].tolist() == [
            sum(int(a[i, j]) * int(b[k - i, j]) for i in range(max(0, k - L + 1), min(k, L - 1) + 1))
            for j in range(len(xs))
        ]
    assert _value(cols) == [x * y for x, y in zip(xs, ys)]
    rinv = pow(R, -1, p)
    red = mont.redc(fs, cols.clone())
    assert int(red[:-1].max()) < 1 << 24
    for x, y, v in zip(xs, ys, _value(red)):
        assert v % p == x * y * rinv % p and v < x * y // R + p
    # Redundant limbs (2^24 moved down from each limb k + 1) carry back.
    plane = _plane(fs, xs)
    plane[:-1] += 1 << 24
    plane[1:] -= 1
    carried = mont.carry(plane)
    assert _value(carried) == xs and int(carried[:-1].max()) < 1 << 24
    below_2p = [v for v in xs if v < 2 * p]
    assert _value(mont.reduce_once(fs, _plane(fs, below_2p))) == [v % p for v in below_2p]
    c = _plane(fs, xs[:3]).T[:, :, None]  # (3, L, 1), as a mont_dot row of constants
    outer = mont.columns(c, a)
    assert outer.shape == (3, 2 * L, len(xs))
    assert [_value(outer[n]) for n in range(3)] == [[xs[n] * x for x in xs] for n in range(3)]


def test_canonicalize_below_2p():
    fs = interop.field_for_modulus(sponge_tpu.BLS12_381_FR.modulus)
    p = fs.modulus
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    # Redundant limbs: move 2^24 from each limb k+1 into limb k.
    plane = torch.from_numpy(np.stack([fs.int_to_limbs(v) for v in vals], -1)).long()
    plane[:-1] += 1 << 24
    plane[1:] -= 1
    out = mont.canonicalize(fs, plane)
    assert limbs_to_ints(fs, out.numpy()) == [v % p for v in vals]
