"""A minimal R1CS constraint system + symbolic field variables (tracer tier).

The reference gates an entire in-circuit mirror of the sponge behind the `r1cs`
feature (ark-r1cs-std / ark-relations; SURVEY.md L5).  That machinery exists to
(a) run the sponge over symbolic values inside a SNARK circuit and (b) count /
check constraints.  The idiomatic equivalent here is an operator-overloaded
tracer field: running the *same* duplex sponge code over ``FpVar`` records the
rank-1 constraint system (a · b = c over linear combinations), supports
witness-satisfaction checking, and reports constraint counts — capability parity
with `ark-relations`' ``ConstraintSystem`` for the sponge's usage surface,
without porting the full gadget library.

Cost model mirrors ark-r1cs-std where the sponge touches it:
  * add / constant-mul / linear combination: 0 constraints;
  * var * var: 1 witness + 1 constraint (fp.rs mul);
  * pow_by_constant(alpha): square-and-multiply chain of muls
    (reference src/poseidon/constraints.rs:47,52);
  * to_bits_le: MODULUS_BIT_SIZE bit witnesses, one booleanity constraint each,
    one packing constraint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..fields import FieldSpec

ONE = -1  # variable index of the constant-one wire


@dataclass
class LinearCombination:
    """Sparse sum of (coeff * variable); the ONE wire carries constants."""

    terms: Dict[int, int] = field(default_factory=dict)

    @staticmethod
    def constant(c: int) -> "LinearCombination":
        return LinearCombination({ONE: c} if c else {})

    @staticmethod
    def of(var: int, coeff: int = 1) -> "LinearCombination":
        return LinearCombination({var: coeff} if coeff else {})

    def scaled(self, c: int, p: int) -> "LinearCombination":
        if c % p == 0:
            return LinearCombination()
        return LinearCombination(
            {v: (k * c) % p for v, k in self.terms.items() if (k * c) % p}
        )

    def plus(self, other: "LinearCombination", p: int) -> "LinearCombination":
        out = dict(self.terms)
        for v, k in other.terms.items():
            nk = (out.get(v, 0) + k) % p
            if nk:
                out[v] = nk
            else:
                out.pop(v, None)
        return LinearCombination(out)


class ConstraintSystem:
    """Collects a · b = c rank-1 constraints with a concrete witness assignment."""

    def __init__(self, fs: FieldSpec):
        self.fs = fs
        self.witness: List[int] = []
        self.constraints: List[Tuple[LinearCombination, LinearCombination, LinearCombination]] = []

    @property
    def num_witness_variables(self) -> int:
        return len(self.witness)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def new_witness(self, value: int) -> int:
        self.witness.append(value % self.fs.modulus)
        return len(self.witness) - 1

    def enforce(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        self.constraints.append((a, b, c))

    def eval_lc(self, lc: LinearCombination) -> int:
        p = self.fs.modulus
        acc = 0
        for v, k in lc.terms.items():
            acc += k * (1 if v == ONE else self.witness[v])
        return acc % p

    def is_satisfied(self) -> bool:
        for a, b, c in self.constraints:
            if self.eval_lc(a) * self.eval_lc(b) % self.fs.modulus != self.eval_lc(c):
                return False
        return True


class FpVar:
    """Symbolic field element: a linear combination plus its concrete value.

    Mirrors ark-r1cs-std ``FpVar`` closely enough for the sponge: constants stay
    constraint-free; variable products allocate one witness + one constraint.
    """

    def __init__(self, cs: Optional[ConstraintSystem], lc: LinearCombination, value: int, fs: FieldSpec):
        self.cs = cs
        self.lc = lc
        self.value = value % fs.modulus
        self.fs = fs

    # ---- constructors ----

    @staticmethod
    def constant(value: int, fs: FieldSpec) -> "FpVar":
        return FpVar(None, LinearCombination.constant(value % fs.modulus), value, fs)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value: int) -> "FpVar":
        idx = cs.new_witness(value)
        return FpVar(cs, LinearCombination.of(idx), value, cs.fs)

    @property
    def is_constant(self) -> bool:
        return self.cs is None

    def _sys(self, other: Optional["FpVar"] = None) -> Optional[ConstraintSystem]:
        if self.cs is not None:
            return self.cs
        return other.cs if other is not None else None

    # ---- linear ops (constraint-free) ----

    def __add__(self, other):
        if isinstance(other, int):
            other = FpVar.constant(other, self.fs)
        p = self.fs.modulus
        return FpVar(
            self._sys(other), self.lc.plus(other.lc, p), (self.value + other.value) % p, self.fs
        )

    __radd__ = __add__

    def mul_constant(self, c: int) -> "FpVar":
        p = self.fs.modulus
        return FpVar(self.cs, self.lc.scaled(c % p, p), self.value * c % p, self.fs)

    # ---- multiplication (1 constraint unless a side is constant) ----

    def __mul__(self, other):
        if isinstance(other, int):
            return self.mul_constant(other)
        p = self.fs.modulus
        if self.is_constant:
            return other.mul_constant(self.value)
        if other.is_constant:
            return self.mul_constant(other.value)
        cs = self._sys(other)
        out = FpVar.new_witness(cs, self.value * other.value % p)
        cs.enforce(self.lc, other.lc, out.lc)
        return out

    __rmul__ = __mul__

    def pow_by_constant(self, alpha: int) -> "FpVar":
        """MSB-first square-and-multiply, as FpVar::pow_by_constant
        (used at poseidon/constraints.rs:47,52)."""
        assert alpha >= 1
        acc = self
        for bit in bin(alpha)[2:][1:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    # ---- bit decomposition (ToBitsGadget analogue) ----

    def to_bits_le(self) -> List["Boolean"]:
        """MODULUS_BIT_SIZE little-endian bits: one booleanity constraint per bit
        plus one packing constraint tying them to this LC."""
        fs = self.fs
        cs = self.cs
        if cs is None:
            return [Boolean.constant(((self.value >> i) & 1) == 1, fs) for i in range(fs.modulus_bit_size)]
        p = fs.modulus
        bits = []
        pack = LinearCombination()
        for i in range(fs.modulus_bit_size):
            bit_val = (self.value >> i) & 1
            b = Boolean.new_witness(cs, bit_val == 1, fs)
            bits.append(b)
            pack = pack.plus(b.var.lc.scaled(pow(2, i, p), p), p)
        # packing: pack - self == 0  (enforced as 0 * 0 = pack - self)
        diff = pack.plus(self.lc.scaled(p - 1, p), p)
        cs.enforce(LinearCombination(), LinearCombination(), diff)
        return bits

    def to_bytes(self) -> List["UInt8"]:
        """ToBytesGadget analogue: LE bytes from the bit decomposition."""
        bits = self.to_bits_le()
        fs = self.fs
        nbytes = (fs.modulus_bit_size + 7) // 8
        while len(bits) < nbytes * 8:
            bits.append(Boolean.constant(False, fs))
        return [UInt8(bits[i * 8 : (i + 1) * 8]) for i in range(nbytes)]


class Boolean:
    """A boolean circuit variable (booleanity-constrained FpVar)."""

    def __init__(self, var: FpVar, value: bool):
        self.var = var
        self.value = bool(value)

    @staticmethod
    def constant(value: bool, fs: FieldSpec) -> "Boolean":
        return Boolean(FpVar.constant(int(value), fs), value)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value: bool, fs: FieldSpec) -> "Boolean":
        v = FpVar.new_witness(cs, int(value))
        # booleanity: b * (1 - b) = 0
        p = fs.modulus
        one_minus = LinearCombination.constant(1).plus(v.lc.scaled(p - 1, p), p)
        cs.enforce(v.lc, one_minus, LinearCombination())
        return Boolean(v, value)

    def to_fp(self) -> FpVar:
        return self.var


class UInt8:
    """Eight little-endian Booleans (ark-r1cs-std UInt8 analogue)."""

    def __init__(self, bits: List[Boolean]):
        assert len(bits) == 8
        self.bits = bits

    @property
    def value(self) -> int:
        return sum(int(b.value) << i for i, b in enumerate(self.bits))

    @staticmethod
    def constant(value: int, fs: FieldSpec) -> "UInt8":
        return UInt8([Boolean.constant(((value >> i) & 1) == 1, fs) for i in range(8)])

    @staticmethod
    def constant_vec(data: bytes, fs: FieldSpec) -> List["UInt8"]:
        return [UInt8.constant(b, fs) for b in data]
