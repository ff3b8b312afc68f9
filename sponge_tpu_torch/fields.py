"""Prime-field specifications and the ints <-> limb-plane codecs of the port.

Counterpart of ``sponge_tpu/fields.py`` with the limb plan chosen for a GPU:
a field element batch is a ``(..., L, B)`` ``int32`` plane of ``L`` 24-bit
limbs (little-endian, batch innermost), in Montgomery form with
``R = 2**(24 * L)``.

Why 24-bit limbs: every limb product is below 2**48, so a column of all the
products of a lazily accumulated Montgomery dot product plus its REDC terms
stays far below 2**63.  The CUDA kernels accumulate such columns in 64-bit
registers (``mul.wide.u32``), and the plain PyTorch tier computes the very
same columns in signed ``int64`` on any device without overflow.

The limb count follows the JAX package's rule with 24 in place of 12,
``L = ceil((bits + 4) / 24)``.  For the 255/254-bit fields that is 11 limbs
and ``R = 2**264``, the same R as the JAX package's 22 x 12-bit plan, so
Montgomery values agree and only the chunking differs.

Planes the port hands between functions are canonical: value below p and
every limb below 2**24.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .utils import native

LIMB_BITS = 24
LIMB_MASK = (1 << LIMB_BITS) - 1
_LIMB_BYTES = LIMB_BITS // 8


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in the 24-bit limb-plane layout.

    All members are Python ints, so a spec is hashable and can key caches.
    """

    name: str
    modulus: int
    generator: int
    nlimbs: int = field(init=False)

    def __post_init__(self):
        # R = 2^(24 L) must exceed every lazily reduced in-kernel value; the
        # +4 bits give R >= 16p, as in the JAX package.  The kernels' own
        # static value simulation (ops/bounds.py) checks each config against R.
        object.__setattr__(
            self, "nlimbs", -(-(self.modulus.bit_length() + 4) // LIMB_BITS)
        )

    @property
    def modulus_bit_size(self) -> int:
        """Same as ark-ff ``MODULUS_BIT_SIZE`` (bits of the modulus)."""
        return self.modulus.bit_length()

    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(24 * nlimbs)."""
        return 1 << (LIMB_BITS * self.nlimbs)

    @property
    def r_mod_p(self) -> int:
        return self.r % self.modulus

    @property
    def r2_mod_p(self) -> int:
        return (self.r * self.r) % self.modulus

    @property
    def r_inv(self) -> int:
        return pow(self.r, -1, self.modulus)

    @property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^24 (the per-limb Montgomery factor)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    # ---- scalar codecs ----

    def int_to_limbs(self, x: int) -> np.ndarray:
        """Integer in [0, R) -> (nlimbs,) int32 limb vector."""
        if not 0 <= x < self.r:
            raise ValueError(f"value out of range for limb encoding: {x}")
        return ints_to_limbs(self, [x])[:, 0]

    def limbs_to_int(self, limbs) -> int:
        """(nlimbs,) limb vector (limbs may be redundant) -> integer."""
        acc = 0
        for i in reversed(range(self.nlimbs)):
            acc = (acc << LIMB_BITS) + int(limbs[i])
        return acc

    def to_mont(self, x: int) -> int:
        return (x % self.modulus) * self.r_mod_p % self.modulus

    def from_mont(self, x: int) -> int:
        return x * self.r_inv % self.modulus

    # ---- batch codecs: python ints <-> (..., L, B) numpy planes ----

    def ints_to_mont_plane(self, xs) -> np.ndarray:
        """Sequence of ints -> (nlimbs, B) int32 Montgomery limb plane.

        The 253-256-bit fields go through the native codec
        (``csrc/host/host_codec.cc``: one word-CIOS multiply per element)
        when it is built; every other case takes the pure-Python path.
        """
        xs = [int(x) % self.modulus for x in xs]
        if len(xs) >= 8 and native.codec_field(self):
            buf = b"".join(x.to_bytes(32, "little") for x in xs)
            out = native.encode_mont_plane_native(self, buf, len(xs))
            if out is not None:
                return out
        return ints_to_limbs(self, [self.to_mont(x) for x in xs])

    def mont_plane_to_ints(self, plane) -> list:
        """(nlimbs, B) canonical Montgomery limb plane -> list of canonical
        ints (through the native codec where ``ints_to_mont_plane`` uses it)."""
        plane = np.asarray(plane)
        if plane.ndim == 2 and plane.shape[-1] >= 8 and native.codec_field(self):
            _check_canonical_limbs(self, plane)
            raw = native.decode_mont_plane_native(self, plane)
            if raw is not None:
                return [
                    int.from_bytes(raw[i * 32 : (i + 1) * 32], "little")
                    for i in range(plane.shape[-1])
                ]
        return [self.from_mont(v) for v in limbs_to_ints(self, plane)]

    # ---- byte codecs matching ark-ff semantics ----

    @property
    def num_canonical_bytes(self) -> int:
        """Bytes of a canonical serialization (ark-serialize compressed Fp)."""
        return (self.modulus_bit_size + 7) // 8

    def to_bytes_le(self, x: int) -> bytes:
        """Canonical LE bytes, ``8 * NUM_LIMBS`` of ark-ff's 64-bit limbs."""
        nbytes = 8 * ((self.modulus_bit_size + 63) // 64)
        return int(x % self.modulus).to_bytes(nbytes, "little")

    def from_le_bytes_mod_order(self, data: bytes) -> int:
        """ark-ff ``from_le_bytes_mod_order``."""
        return int.from_bytes(data, "little") % self.modulus


def ints_to_limbs(fs: FieldSpec, xs) -> np.ndarray:
    """Ints in [0, R) -> (L, B) int32 plane of 24-bit limbs (vectorized)."""
    xs = [int(x) for x in xs]
    L = fs.nlimbs
    if any(x < 0 or x >= fs.r for x in xs):
        raise ValueError("value out of range for limb encoding")
    raw = b"".join(x.to_bytes(_LIMB_BYTES * L, "little") for x in xs)
    by = np.frombuffer(raw, dtype=np.uint8).reshape(len(xs), L, _LIMB_BYTES)
    by = by.astype(np.int32)
    limbs = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16)
    return np.ascontiguousarray(limbs.T)


def _check_canonical_limbs(fs: FieldSpec, plane: np.ndarray) -> None:
    if plane.shape[0] != fs.nlimbs:
        raise ValueError(f"expected {fs.nlimbs} limbs, got shape {plane.shape}")
    if plane.size and (plane.min() < 0 or plane.max() > LIMB_MASK):
        raise ValueError("limb plane is not canonical (limbs must be < 2^24)")


def limbs_to_ints(fs: FieldSpec, plane) -> list:
    """(L, B) plane of canonical 24-bit limbs -> list of ints."""
    plane = np.asarray(plane)
    _check_canonical_limbs(fs, plane)
    lanes = plane.T.astype(np.uint32)  # (B, L)
    by = np.stack([(lanes >> s) & 0xFF for s in (0, 8, 16)], axis=-1)
    raw = by.astype(np.uint8).tobytes()
    n = _LIMB_BYTES * fs.nlimbs
    return [int.from_bytes(raw[i * n : (i + 1) * n], "little") for i in range(lanes.shape[0])]


def ints_to_mont_tensor(fs: FieldSpec, values, device) -> torch.Tensor:
    """(k, B) or (B,) python-int grid -> (k, L, B) or (L, B) int32 Montgomery
    plane on ``device``."""
    arr = np.asarray(values, dtype=object)
    flat = fs.ints_to_mont_plane(arr.reshape(-1))  # (L, k*B)
    if arr.ndim == 2:
        k, B = arr.shape
        flat = flat.reshape(fs.nlimbs, k, B).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device)


def mont_tensor_to_ints(fs: FieldSpec, plane: torch.Tensor) -> list:
    """(L, B) or (k, L, B) canonical Montgomery plane -> ints ([B] or [k][B])."""
    arr = plane.detach().cpu().numpy()
    if arr.ndim == 2:
        return fs.mont_plane_to_ints(arr)
    return [fs.mont_plane_to_ints(row) for row in arr]


BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
)

# The JAX package's 13-bit plan of the same field; the port has one limb
# plan, so this is the same field.
BLS12_381_FR_L13 = BLS12_381_FR

BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
)

BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    modulus=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
)

GOLDILOCKS_FR = FieldSpec(
    name="goldilocks_fr",
    modulus=(1 << 64) - (1 << 32) + 1,
    generator=7,
)

BABYBEAR_FR = FieldSpec(
    name="babybear_fr",
    modulus=(15 << 27) + 1,
    generator=31,
)

MERSENNE31_FR = FieldSpec(
    name="mersenne31_fr",
    modulus=(1 << 31) - 1,
    generator=7,
)

KOALABEAR_FR = FieldSpec(
    name="koalabear_fr",
    modulus=(1 << 31) - (1 << 24) + 1,
    generator=3,
)

_FIELDS = {
    f.name: f
    for f in (
        BLS12_381_FR,
        BN254_FR,
        BLS12_377_FR,
        GOLDILOCKS_FR,
        BABYBEAR_FR,
        MERSENNE31_FR,
        KOALABEAR_FR,
    )
}


def get_field(name: str) -> FieldSpec:
    return _FIELDS[name]
