"""Scalar python-int Poseidon duplex sponge: the exactness oracle of the port.

Counterpart of ``sponge_tpu/poseidon/oracle.py`` (with ``OracleField`` from
``sponge_tpu/ops/montgomery.py``).  It needs neither JAX nor a GPU, so
``chip_smoke.py`` uses it as ground truth on the card's machine.

Reference quirks kept on purpose: absorb *adds* into the rate part of the
``capacity ‖ rate`` state, and the squeeze loop skips the permutation when
the remaining output length equals the rate.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import absorb as absorb_codec
from ..fields import FieldSpec
from .config import PoseidonConfig

ABSORBING = "absorbing"
SQUEEZING = "squeezing"

FULL = "full"


@dataclass(frozen=True)
class Truncated:
    """``FieldElementSize::Truncated``."""

    num_bits: int


def field_element_size_num_bits(size, fs: FieldSpec) -> int:
    """``FieldElementSize::num_bits``: always MODULUS_BIT_SIZE - 1;
    ``Truncated(n)`` only bounds-checks (reference quirk)."""
    if isinstance(size, Truncated) and size.num_bits > fs.modulus_bit_size:
        raise ValueError("num_bits is greater than the capacity of the field.")
    return fs.modulus_bit_size - 1


def field_element_size_sum(sizes, fs: FieldSpec) -> int:
    """``FieldElementSize::sum``: the bits a size list yields (each size
    ``field_element_size_num_bits``)."""
    return sum(field_element_size_num_bits(s, fs) for s in sizes)


def bits_le_to_bytes(bits) -> bytes:
    """LE bit chunks -> bytes, as in the non-native squeeze."""
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for j, bit in enumerate(bits[i : i + 8]):
            if bit:
                byte |= 1 << j
        out.append(byte)
    return bytes(out)


class OracleField:
    """Python-int field arithmetic (canonical values mod p)."""

    def __init__(self, fs: FieldSpec):
        self.fs = fs
        self.p = fs.modulus

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)


@dataclass
class SpongeState:
    """Externalized sponge state (``SpongeExt``)."""

    state: list
    mode: str
    index: int


class OraclePoseidonSponge:
    """Reference-exact duplex sponge over python ints."""

    def __init__(self, cfg: PoseidonConfig):
        self.cfg = cfg
        self.f = OracleField(cfg.field)
        self.state = [0] * cfg.t
        self.mode = ABSORBING
        self.index = 0

    # ---- permutation ----

    def permute(self):
        cfg, f = self.cfg, self.f
        half = cfg.full_rounds // 2
        state = list(self.state)
        for r in range(cfg.rounds):
            state = [f.add(x, c) for x, c in zip(state, cfg.ark[r])]
            if r < half or r >= half + cfg.partial_rounds:
                state = [f.pow(x, cfg.alpha) for x in state]
            else:
                state[0] = f.pow(state[0], cfg.alpha)
            state = [
                sum(m * x for m, x in zip(row, state)) % f.p for row in cfg.mds
            ]
        self.state = state

    # ---- duplex state machine ----

    def _absorb_internal(self, rate_start_index: int, elements):
        cfg = self.cfg
        remaining = list(elements)
        while True:
            if rate_start_index + len(remaining) <= cfg.rate:
                for i, elem in enumerate(remaining):
                    idx = cfg.capacity + i + rate_start_index
                    self.state[idx] = self.f.add(self.state[idx], elem)
                self.mode = ABSORBING
                self.index = rate_start_index + len(remaining)
                return
            num_absorbed = cfg.rate - rate_start_index
            for i in range(num_absorbed):
                idx = cfg.capacity + i + rate_start_index
                self.state[idx] = self.f.add(self.state[idx], remaining[i])
            self.permute()
            remaining = remaining[num_absorbed:]
            rate_start_index = 0

    def _squeeze_internal(self, rate_start_index: int, num: int):
        cfg = self.cfg
        out = []
        remaining = num
        while True:
            s = cfg.capacity + rate_start_index
            if rate_start_index + remaining <= cfg.rate:
                out.extend(self.state[s : s + remaining])
                self.mode = SQUEEZING
                self.index = rate_start_index + remaining
                return out
            num_squeezed = cfg.rate - rate_start_index
            out.extend(self.state[s : s + num_squeezed])
            # Reference quirk: no permute when the remaining output equals the rate.
            if remaining != cfg.rate:
                self.permute()
            remaining -= num_squeezed
            rate_start_index = 0

    def absorb_field_elements(self, elems):
        elems = [e % self.cfg.field.modulus for e in elems]
        if not elems:
            return
        if self.mode == ABSORBING:
            absorb_index = self.index
            if absorb_index == self.cfg.rate:
                self.permute()
                absorb_index = 0
            self._absorb_internal(absorb_index, elems)
        else:
            self.permute()
            self._absorb_internal(0, elems)

    def squeeze_native_field_elements(self, num: int):
        if self.mode == ABSORBING:
            self.permute()
            return self._squeeze_internal(0, num)
        squeeze_index = self.index
        if squeeze_index == self.cfg.rate:
            self.permute()
            squeeze_index = 0
        return self._squeeze_internal(squeeze_index, num)

    # ---- CryptographicSponge surface ----

    def absorb(self, x):
        self.absorb_field_elements(absorb_codec.to_sponge_field_elements(x, self.cfg.field))

    def squeeze_bytes(self, num_bytes: int):
        """Low ``(MODULUS_BIT_SIZE-1)/8`` LE bytes of each element."""
        fs = self.cfg.field
        usable_bytes = (fs.modulus_bit_size - 1) // 8
        num_elements = (num_bytes + usable_bytes - 1) // usable_bytes
        out = bytearray()
        for e in self.squeeze_native_field_elements(num_elements):
            out.extend(fs.to_bytes_le(e)[:usable_bytes])
        return bytes(out[:num_bytes])

    def squeeze_bits(self, num_bits: int):
        """Low ``MODULUS_BIT_SIZE-1`` LE bits of each element."""
        fs = self.cfg.field
        usable_bits = fs.modulus_bit_size - 1
        num_elements = (num_bits + usable_bits - 1) // usable_bits
        bits = []
        for e in self.squeeze_native_field_elements(num_elements):
            bits.extend(((e >> i) & 1) == 1 for i in range(usable_bits))
        return bits[:num_bits]

    def squeeze_field_elements_with_sizes(self, target_fs: FieldSpec, sizes):
        if self.cfg.field.modulus == target_fs.modulus:
            native = self.squeeze_native_field_elements_with_sizes(sizes)
            return [v % target_fs.modulus for v in native]
        return self._squeeze_nonnative_default(target_fs, sizes)

    def squeeze_field_elements(self, target_fs: FieldSpec, num: int):
        if self.cfg.field.modulus == target_fs.modulus:
            return list(self.squeeze_native_field_elements(num))
        return self.squeeze_field_elements_with_sizes(target_fs, [FULL] * num)

    def squeeze_native_field_elements_with_sizes(self, sizes):
        if all(s == FULL for s in sizes):
            return self.squeeze_native_field_elements(len(sizes))
        return self._squeeze_nonnative_default(self.cfg.field, sizes)

    def _squeeze_nonnative_default(self, target_fs: FieldSpec, sizes):
        """Bit-packing default: each size contributes MODULUS_BIT_SIZE(target)-1
        bits, squeezed through the native field's ``squeeze_bits``."""
        if len(sizes) == 0:
            return []
        per = [field_element_size_num_bits(s, target_fs) for s in sizes]
        bits = self.squeeze_bits(sum(per))
        out = []
        pos = 0
        for n in per:
            out.append(target_fs.from_le_bytes_mod_order(bits_le_to_bytes(bits[pos : pos + n])))
            pos += n
        return out

    def fork(self, domain: bytes) -> "OraclePoseidonSponge":
        """Domain separation: clone, absorb len(domain) ‖ domain."""
        new = self.clone()
        new.absorb(
            absorb_codec.to_sponge_bytes(absorb_codec.Usize(len(domain))) + bytes(domain)
        )
        return new

    def clone(self) -> "OraclePoseidonSponge":
        new = type(self)(self.cfg)
        new.state = list(self.state)
        new.mode = self.mode
        new.index = self.index
        return new

    # ---- SpongeExt ----

    def into_state(self) -> SpongeState:
        return SpongeState(state=list(self.state), mode=self.mode, index=self.index)

    @classmethod
    def from_state(cls, state: SpongeState, cfg: PoseidonConfig) -> "OraclePoseidonSponge":
        new = cls(cfg)
        new.state = list(state.state)
        new.mode = state.mode
        new.index = state.index
        return new
