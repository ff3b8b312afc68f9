"""The port's native codec (``csrc/host/host_codec.cc``, 11 x 24-bit limbs)
against its pure-Python path and the JAX package's native codec.

Encode and decode at BLS12-381, BN254 and BLS12-377 on random values and
on 0, 1, p-1 and p-2; decode of redundant limbs; the gate to the fields the
codec serves exactly; the byte packer against ``bytes_to_field_elements``'s
Python path and the JAX package's packer; and ``FieldSpec`` and the absorb
codec taking the native path without being asked.  Inputs come from numpy
seeds; every comparison is exact.
"""

import numpy as np
import pytest

from sponge_tpu import absorb as jax_absorb
from sponge_tpu.fields import BLS12_381_FR as JAX_BLS12_381_FR
from sponge_tpu.utils import native as jax_native
import sponge_tpu_torch as st
from sponge_tpu_torch import absorb
from sponge_tpu_torch.fields import ints_to_limbs, limbs_to_ints
from sponge_tpu_torch.utils import native

FIELDS = [st.BLS12_381_FR, st.BN254_FR, st.BLS12_377_FR]


@pytest.fixture(scope="module", autouse=True)
def codec(tmp_path_factory):
    """Both packages' codecs.  The JAX package's builds into a directory of
    this module's own, so no other test process shares its temporary file."""
    if native.get_lib() is None:
        pytest.skip("no C++ compiler for the native codec")
    mp = pytest.MonkeyPatch()
    mp.setenv("SPONGE_TPU_CACHE", str(tmp_path_factory.mktemp("jax_codec_cache")))
    try:
        assert jax_native.get_lib() is not None
    finally:
        mp.undo()


def rand_vals(fs, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]
    return vals + [0, 1, fs.modulus - 1, fs.modulus - 2]


def pure_plane(fs, xs):
    return ints_to_limbs(fs, [fs.to_mont(x) for x in xs])


def pure_ints(fs, plane):
    return [fs.from_mont(v) for v in limbs_to_ints(fs, plane)]


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_native_encode_decode_match_python(fs):
    xs = rand_vals(fs, 60, 31)
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    plane = native.encode_mont_plane_native(fs, buf, len(xs))
    assert plane.shape == (11, len(xs)) and plane.dtype == np.int32
    assert np.array_equal(plane, pure_plane(fs, xs))
    raw = native.decode_mont_plane_native(fs, plane)
    assert [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(len(xs))] == xs
    assert pure_ints(fs, plane) == xs


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_native_decode_redundant_limbs(fs):
    """Limbs above 2^24 and values above 2^256 (the canonical value plus 3p,
    and limb carries left undone) decode to the canonical value."""
    xs = rand_vals(fs, 12, 32)
    plane = pure_plane(fs, xs).astype(np.int64) + ints_to_limbs(fs, [3 * fs.modulus]).astype(np.int64)
    plane[0] += 5 << 24  # an unpropagated carry: limb 0 holds 5 * 2^24 more, limb 1 five less
    plane[1] -= 5
    assert plane.min() >= 0 and plane.max() >= (1 << 24)
    raw = native.decode_mont_plane_native(fs, plane.astype(np.int32))
    assert [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(len(xs))] == xs


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_native_decode_refuses_values_past_its_reach(fs):
    """A plane whose limb maxima could reach p * 2^12 raises: the
    reduction's reach, a little past which (2^256 + (2^12 - 1) p) it gives
    wrong values.  The least top limb past p * 2^12 (about 2^27 at
    BLS12-381) and 2^28 both raise; the top limb just below decodes exactly."""
    plane = pure_plane(fs, rand_vals(fs, 4, 33))
    reach = fs.modulus << 12
    for top in (-(-reach // (1 << 240)), 1 << 28):
        plane[10, 2] = top
        with pytest.raises(ValueError, match="decoder's reach"):
            native.decode_mont_plane_native(fs, plane)
    plane[10, 2] = (reach >> 240) - 1  # the canonical lower limbs add less than 2^240
    raw = native.decode_mont_plane_native(fs, plane)
    value = sum(int(plane[l, 2]) << (24 * l) for l in range(11))
    assert int.from_bytes(raw[64:96], "little") == value * pow(1 << 264, -1, fs.modulus) % fs.modulus


def test_native_codec_serves_only_its_fields():
    """Fields off the 11-limb, 253-256-bit plan take the Python path
    (None), and malformed input raises."""
    assert [native.codec_field(fs) for fs in FIELDS] == [True] * 3
    for fs in (st.GOLDILOCKS_FR, st.BABYBEAR_FR, st.FieldSpec("f237", (1 << 237) - 13, 3)):
        assert not native.codec_field(fs)
        assert native.encode_mont_plane_native(fs, bytes(32), 1) is None
        assert native.decode_mont_plane_native(fs, np.zeros((fs.nlimbs, 1), np.int32)) is None
    fs = st.BLS12_381_FR
    with pytest.raises(ValueError, match="64 bytes"):
        native.encode_mont_plane_native(fs, bytes(32), 2)
    with pytest.raises(ValueError, match="negative"):
        native.decode_mont_plane_native(fs, -np.ones((11, 1), np.int32))
    with pytest.raises(ValueError, match="plane"):
        native.decode_mont_plane_native(fs, np.zeros((22, 1), np.int32))


@pytest.mark.parametrize("fs", [st.BLS12_381_FR, st.BN254_FR, st.GOLDILOCKS_FR], ids=lambda f: f.name)
def test_native_byte_packing_matches_python_and_jax(fs):
    rng = np.random.default_rng(33)
    data = bytes(rng.integers(0, 256, size=5003, dtype=np.uint8))
    chunk = (fs.modulus_bit_size - 1) // 8
    want = [int.from_bytes(data[i : i + chunk], "little") for i in range(0, len(data), chunk)]
    assert native.pack_bytes_to_elements_native(fs, data) == want
    assert absorb.bytes_to_field_elements(data, fs) == want
    assert native.pack_bytes_to_elements_native(fs, b"") is None
    if fs is st.BLS12_381_FR:
        assert jax_native.pack_bytes_to_elements_native(JAX_BLS12_381_FR, data) == want
        assert jax_absorb.bytes_to_field_elements(data, JAX_BLS12_381_FR) == want


def test_field_api_uses_native_transparently(monkeypatch):
    """``ints_to_mont_plane``, ``mont_plane_to_ints`` and byte absorbs of
    1 KiB take the native codec at 8 values and more, and agree with the
    Python path; the field API still refuses non-canonical limbs."""
    fs = st.BLS12_381_FR
    xs = rand_vals(fs, 12, 34)
    calls = []
    for name in ("encode_mont_plane_native", "decode_mont_plane_native", "pack_bytes_to_elements_native"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    plane = fs.ints_to_mont_plane(xs)
    assert np.array_equal(plane, pure_plane(fs, xs))
    assert fs.mont_plane_to_ints(plane) == xs
    data = bytes(range(256)) * 4
    assert absorb.to_sponge_field_elements(data, fs) == jax_absorb.to_sponge_field_elements(data, JAX_BLS12_381_FR)
    assert calls == ["encode_mont_plane_native", "decode_mont_plane_native", "pack_bytes_to_elements_native"]
    assert fs.mont_plane_to_ints(plane[:, :3]) == xs[:3] and len(calls) == 3  # short: the Python path
    bad = plane.copy()
    bad[0, 0] += 1 << 24
    with pytest.raises(ValueError, match="not canonical"):
        fs.mont_plane_to_ints(bad)
