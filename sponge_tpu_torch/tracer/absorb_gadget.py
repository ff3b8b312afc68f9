"""AbsorbGadget: the in-circuit Absorb codec over tracer variables.

Mirror of reference src/constraints/absorb.rs in BOTH wire formats:

* field-element mode (``to_sponge_field_elements``, absorb.rs:38-52): every
  circuit type converts into a list of ``FpVar``.  Byte batches are
  length-prefixed with a *constant* length (legitimately constant: circuit
  shape is static, absorb.rs:63-69) and packed through the same 31-byte
  chunking as the native ``ToConstraintField`` — here as linear combinations
  over the byte bits;
* byte mode (``to_sponge_bytes``, absorb.rs:21-35): every type converts into a
  list of ``UInt8``.  Batches concatenate with NO length prefix
  (batch_to_sponge_bytes default, absorb.rs:26-35), matching the native byte
  wire format; ``FpVar`` contributes its full LE byte decomposition
  (``to_bytes``, absorb.rs:83-85), ``Boolean`` one byte (absorb.rs:75-77),
  curve points the bytes of their coordinate field elements
  (absorb.rs:104-112).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..fields import FieldSpec
from .r1cs import Boolean, ConstraintSystem, FpVar, LinearCombination, UInt8


@dataclass
class TEPointVar:
    """Twisted-Edwards affine point gadget: absorbs as [x, y]
    (constraints/absorb.rs:125-128 via to_constraint_field)."""

    x: FpVar
    y: FpVar

    def to_field_elements(self) -> List[FpVar]:
        return [self.x, self.y]


@dataclass
class SWPointVar:
    """Short-Weierstrass affine point gadget: absorbs as [x, y, infinity]."""

    x: FpVar
    y: FpVar
    infinity: Boolean

    def to_field_elements(self) -> List[FpVar]:
        return [self.x, self.y, self.infinity.to_fp()]


def bytes_to_field_elements_gadget(
    bytes_vars: List[UInt8], cs: ConstraintSystem, fs: FieldSpec
) -> List[FpVar]:
    """UInt8 list -> FpVar list via 31-byte LE chunk packing (constraint-free:
    pure linear combination of the constituent bits, as ark's
    ``to_constraint_field`` for bytes)."""
    max_size = (fs.modulus_bit_size - 1) // 8
    p = fs.modulus
    out = []
    for i in range(0, len(bytes_vars), max_size):
        chunk = bytes_vars[i : i + max_size]
        lc = LinearCombination()
        val = 0
        weight = 0
        has_var = False
        for byte in chunk:
            for j, bit in enumerate(byte.bits):
                w = pow(2, weight + j, p)
                lc = lc.plus(bit.var.lc.scaled(w, p), p)
                val += int(bit.value) << (weight + j)
                has_var = has_var or not bit.var.is_constant
            weight += 8
        out.append(FpVar(cs if has_var else None, lc, val % p, fs))
    return out


@dataclass
class OptionVar:
    """``Option<A>`` gadget (constraints/absorb.rs:169-187): the is_some flag
    enters as a *constant* Boolean (circuit shape is static)."""

    value: object = None  # None == Option::None; anything else == Some(value)

    @property
    def is_some(self) -> bool:
        return self.value is not None


def to_sponge_field_elements_gadget(x, cs: ConstraintSystem, fs: FieldSpec) -> List[FpVar]:
    """Dispatch mirroring the AbsorbGadget impls (constraints/absorb.rs:54-196)."""
    if isinstance(x, FpVar):
        return [x]
    if isinstance(x, Boolean):
        return [x.to_fp()]
    if isinstance(x, UInt8):
        return bytes_to_field_elements_gadget([x], cs, fs)
    if isinstance(x, (TEPointVar, SWPointVar)):
        return x.to_field_elements()
    if isinstance(x, OptionVar):
        # constant flag FpVar + payload (absorb.rs:179-187)
        out = [FpVar.constant(int(x.is_some), fs)]
        if x.is_some:
            out.extend(to_sponge_field_elements_gadget(x.value, cs, fs))
        return out
    if isinstance(x, list):
        if x and all(isinstance(e, UInt8) for e in x):
            # u8 batch: constant u64 LE length prefix + packing (absorb.rs:63-69).
            prefix = UInt8.constant_vec(len(x).to_bytes(8, "little"), fs)
            return bytes_to_field_elements_gadget(prefix + x, cs, fs)
        if x and all(isinstance(e, FpVar) for e in x):
            return list(x)  # FpVar batch: identity (absorb.rs:92-94)
        out: List[FpVar] = []
        for e in x:
            out.extend(to_sponge_field_elements_gadget(e, cs, fs))
        return out
    raise TypeError(f"not gadget-absorbable: {type(x)!r}")


def absorb_gadget(sponge, *items) -> None:
    """``absorb_gadget!`` macro analogue (constraints/absorb.rs:201-210):
    absorb each item in sequence."""
    for item in items:
        sponge.absorb(item)


def collect_sponge_field_elements_gadget(
    cs: ConstraintSystem, fs: FieldSpec, *items
) -> List[FpVar]:
    """``collect_sponge_field_elements_gadget!`` macro analogue
    (constraints/absorb.rs:213-223): concatenate each item's field-element
    encoding."""
    out: List[FpVar] = []
    for item in items:
        out.extend(to_sponge_field_elements_gadget(item, cs, fs))
    return out


def to_sponge_bytes_gadget(x, cs: ConstraintSystem, fs: FieldSpec) -> List[UInt8]:
    """Byte-mode dispatch mirroring ``AbsorbGadget::to_sponge_bytes`` /
    ``batch_to_sponge_bytes`` (constraints/absorb.rs:21-35, impls :54-196)."""
    if isinstance(x, UInt8):
        return [x]  # absorb.rs:56-58
    if isinstance(x, Boolean):
        # Boolean::to_bytes(): one byte, bit 0 = self (absorb.rs:75-77).
        return [UInt8([x] + [Boolean.constant(False, fs) for _ in range(7)])]
    if isinstance(x, FpVar):
        return x.to_bytes()  # FpVar::to_bytes(), absorb.rs:83-85
    if isinstance(x, (TEPointVar, SWPointVar)):
        # to_constraint_field() then per-element to_sponge_bytes
        # (absorb.rs:104-112 via impl_absorbable_group).
        out: List[UInt8] = []
        for e in x.to_field_elements():
            out.extend(to_sponge_bytes_gadget(e, cs, fs))
        return out
    if isinstance(x, OptionVar):
        # constant flag byte + payload bytes (absorb.rs:170-177).
        out = to_sponge_bytes_gadget(Boolean.constant(x.is_some, fs), cs, fs)
        if x.is_some:
            out.extend(to_sponge_bytes_gadget(x.value, cs, fs))
        return out
    if isinstance(x, list):
        # batch_to_sponge_bytes default: plain concat, NO length prefix
        # (absorb.rs:26-35; u8 batches match the native extend_from_slice,
        # absorb.rs native :131-133).
        out = []
        for e in x:
            out.extend(to_sponge_bytes_gadget(e, cs, fs))
        return out
    raise TypeError(f"not gadget-absorbable (byte mode): {type(x)!r}")
