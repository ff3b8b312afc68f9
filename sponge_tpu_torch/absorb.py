"""The Absorb input codec: typed host values -> sponge wire formats.

Counterpart of ``sponge_tpu/absorb.py`` (pure Python, host side).  The sponge
consumes a byte stream and a field-element stream; every absorbable type
defines its encoding into both.

Type mapping (reference impl -> here):
  u8..u128, i8..i128   -> ``U8(..)`` .. ``I128(..)`` int subclasses
  usize / isize        -> ``Usize`` / ``Isize`` (64-bit semantics)
  bool                 -> python ``bool``
  Fp                   -> ``Fp(value, field)``
  &[u8] / Vec<u8>      -> python ``bytes`` / ``bytearray``
  &[A] / Vec<A>        -> python ``list``
  Option<A>            -> ``Some(x)`` / ``NONE``
  TEAffine / SWAffine  -> ``TEPoint`` / ``SWPoint``
  AbsorbWithLength     -> ``WithLength(x)``
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .fields import FieldSpec
from .utils import native


class _TypedInt(int):
    """Fixed-width integer wrapper carrying the reference's absorb semantics."""

    BITS: int = 0
    SIGNED: bool = False

    def __new__(cls, value: int):
        bits, signed = cls.BITS, cls.SIGNED
        lo = -(1 << (bits - 1)) if signed else 0
        hi = (1 << (bits - 1)) if signed else (1 << bits)
        if not lo <= int(value) < hi:
            raise ValueError(f"{cls.__name__} out of range: {value}")
        return super().__new__(cls, value)


def _make_int(name: str, bits: int, signed: bool):
    return type(name, (_TypedInt,), {"BITS": bits, "SIGNED": signed})


U8 = _make_int("U8", 8, False)
U16 = _make_int("U16", 16, False)
U32 = _make_int("U32", 32, False)
U64 = _make_int("U64", 64, False)
U128 = _make_int("U128", 128, False)
I8 = _make_int("I8", 8, True)
I16 = _make_int("I16", 16, True)
I32 = _make_int("I32", 32, True)
I64 = _make_int("I64", 64, True)
I128 = _make_int("I128", 128, True)
Usize = _make_int("Usize", 64, False)
Isize = _make_int("Isize", 64, True)


@dataclass(frozen=True)
class Fp:
    """A prime-field element tagged with its field."""

    value: int
    field: FieldSpec

    def __post_init__(self):
        object.__setattr__(self, "value", int(self.value) % self.field.modulus)


@dataclass(frozen=True)
class Some:
    """``Option::Some``."""

    value: object


class _NoneType:
    """``Option::None`` singleton."""

    _instance: Optional["_NoneType"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NONE"


NONE = _NoneType()


@dataclass(frozen=True)
class WithLength:
    """``AbsorbWithLength``: prepend the element count."""

    value: object


@dataclass(frozen=True)
class SWPoint:
    """Short-Weierstrass affine point: absorbs as [x, y, infinity]."""

    x: Fp
    y: Fp
    infinity: bool = False

    def to_field_elements(self):
        return [self.x, self.y, Fp(int(self.infinity), self.x.field)]


@dataclass(frozen=True)
class TEPoint:
    """Twisted-Edwards affine point: absorbs as [x, y]."""

    x: Fp
    y: Fp

    def to_field_elements(self):
        return [self.x, self.y]


# ---- field-element wire format ----


def bytes_to_field_elements(data: bytes, fs: FieldSpec) -> list:
    """Pack bytes into chunks of ``(MODULUS_BIT_SIZE - 1) / 8`` LE bytes
    (1 KiB and more through the native packer when it is built)."""
    if len(data) >= 1024:
        packed = native.pack_bytes_to_elements_native(fs, data)
        if packed is not None:
            return packed
    max_size = (fs.modulus_bit_size - 1) // 8
    return [
        int.from_bytes(data[i : i + max_size], "little")
        for i in range(0, len(data), max_size)
    ]


def _u8_batch_to_field_elements(data: bytes, fs: FieldSpec) -> list:
    """u8 batch: u64 LE length prefix, then the packed bytes."""
    return bytes_to_field_elements(len(data).to_bytes(8, "little") + bytes(data), fs)


def field_cast(values, src: FieldSpec, dst: FieldSpec) -> Optional[list]:
    """Same-characteristic checked cast; None on mismatch."""
    if src.modulus != dst.modulus:
        return None
    return [int(v) % dst.modulus for v in values]


def to_sponge_field_elements(x, fs: FieldSpec, dest: Optional[list] = None) -> list:
    """Encode ``x`` into the field-element wire format for field ``fs``."""
    out = dest if dest is not None else []
    if isinstance(x, bool):
        out.append(int(x))
    elif isinstance(x, _TypedInt):
        v = int(x)
        if x.SIGNED and v < 0:
            out.append((-abs(v)) % fs.modulus)
        else:
            out.append(v % fs.modulus)
    elif isinstance(x, int):
        raise TypeError(
            "plain python ints are ambiguous; wrap in U8..U128/I8..I128/Usize/Fp"
        )
    elif isinstance(x, Fp):
        # A single non-native Fp is silently skipped, as in the reference.
        cast = field_cast([x.value], x.field, fs)
        if cast is not None:
            out.extend(cast)
    elif isinstance(x, (bytes, bytearray)):
        out.extend(_u8_batch_to_field_elements(bytes(x), fs))
    elif isinstance(x, list):
        _batch_to_field_elements(x, fs, out)
    elif isinstance(x, Some):
        out.append(1)
        to_sponge_field_elements(x.value, fs, out)
    elif x is NONE:
        out.append(0)
    elif isinstance(x, (SWPoint, TEPoint)):
        coords = x.to_field_elements()
        cast = field_cast([c.value for c in coords], coords[0].field, fs)
        if cast is None:
            raise ValueError("absorbing curve point over a non-native base field")
        out.extend(cast)
    elif isinstance(x, WithLength):
        to_sponge_field_elements(Usize(_absorb_length(x.value)), fs, out)
        to_sponge_field_elements(x.value, fs, out)
    else:
        raise TypeError(f"not absorbable: {type(x)!r}")
    return out


def _batch_to_field_elements(batch: list, fs: FieldSpec, out: list):
    """``&[A]`` batch semantics: per-type batch impl, default = concat each."""
    if batch and all(isinstance(e, U8) for e in batch):
        out.extend(_u8_batch_to_field_elements(bytes(int(e) for e in batch), fs))
        return
    if batch and all(isinstance(e, Fp) for e in batch):
        cast = field_cast([e.value for e in batch], batch[0].field, fs)
        if cast is None:
            raise ValueError("Trying to absorb non-native field elements.")
        out.extend(cast)
        return
    for e in batch:
        to_sponge_field_elements(e, fs, out)


def _absorb_length(x) -> int:
    if isinstance(x, (bytes, bytearray, list)):
        return len(x)
    raise TypeError(f"AbsorbWithLength requires a sequence, got {type(x)!r}")


# ---- byte wire format ----


def _fp_serialize_compressed(x: Fp) -> bytes:
    return x.value.to_bytes(x.field.num_canonical_bytes, "little")


def to_sponge_bytes(x, dest: Optional[bytearray] = None) -> bytes:
    """Encode ``x`` into the byte wire format."""
    out = dest if dest is not None else bytearray()
    if isinstance(x, bool):
        out.append(int(x))
    elif isinstance(x, _TypedInt):
        out.extend(int(x).to_bytes(x.BITS // 8, "little", signed=x.SIGNED))
    elif isinstance(x, int):
        raise TypeError(
            "plain python ints are ambiguous; wrap in U8..U128/I8..I128/Usize/Fp"
        )
    elif isinstance(x, Fp):
        out.extend(_fp_serialize_compressed(x))
    elif isinstance(x, (bytes, bytearray)):
        out.extend(bytes(x))
    elif isinstance(x, list):
        if x and all(isinstance(e, U8) for e in x):
            out.extend(bytes(int(e) for e in x))
        else:
            for e in x:
                to_sponge_bytes(e, out)
    elif isinstance(x, Some):
        out.append(1)
        to_sponge_bytes(x.value, out)
    elif x is NONE:
        out.append(0)
    elif isinstance(x, (SWPoint, TEPoint)):
        coords = x.to_field_elements()
        out.extend(len(coords).to_bytes(8, "little"))
        for c in coords:
            out.extend(_fp_serialize_compressed(c))
    elif isinstance(x, WithLength):
        to_sponge_bytes(Usize(_absorb_length(x.value)), out)
        to_sponge_bytes(x.value, out)
    else:
        raise TypeError(f"not absorbable: {type(x)!r}")
    return bytes(out)



def collect_sponge_bytes(*items) -> bytes:
    """The byte wire format of several values, concatenated
    (``collect_sponge_bytes!``)."""
    out = bytearray()
    for item in items:
        to_sponge_bytes(item, out)
    return bytes(out)


def collect_sponge_field_elements(fs: FieldSpec, *items) -> list:
    """The field-element wire format of several values, concatenated
    (``collect_sponge_field_elements!``)."""
    out = []
    for item in items:
        to_sponge_field_elements(item, fs, out)
    return out
