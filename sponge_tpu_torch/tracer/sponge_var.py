"""Symbolic (in-circuit) Poseidon sponge over the tracer field.

Mirror of ``PoseidonSpongeVar`` (reference src/poseidon/constraints.rs) and
the ``CryptographicSpongeVar`` trait (reference src/constraints/mod.rs:101-188):
the *same* duplex state machine as the native sponge, evaluated over ``FpVar``
linear combinations so that absorb/squeeze sequences emit an R1CS whose witness
reproduces the native sponge bit-exactly (enforced by tests).

The S-box uses ``pow_by_constant`` (square-and-multiply muls -> constraints);
ARK adds and the MDS matrix are constant-coefficient linear combinations and are
constraint-free, exactly as in the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..fields import FieldSpec
from ..poseidon.config import PoseidonConfig
from ..poseidon.oracle import FULL, field_element_size_num_bits
from .absorb_gadget import to_sponge_field_elements_gadget
from .r1cs import Boolean, ConstraintSystem, FpVar, LinearCombination, UInt8

ABSORBING = "absorbing"
SQUEEZING = "squeezing"


def bits_le_to_nonnative(
    cs: ConstraintSystem,
    all_bits: Sequence[Sequence[Boolean]],
    target_fs: FieldSpec,
    optimization_type: str = "constraints",
) -> List[List[FpVar]]:
    """Pack little-endian bit vectors into nonnative limb variables.

    Mirror of reference src/constraints/mod.rs:19-89 with ark-r1cs-std's
    limb geometry: limb count/size come from ``get_params(F, CF,
    OptimizationType)`` (tracer.nonnative), the per-bit weights come from a
    ``get_limbs_representations(2^j mod F)`` lookup table, limbs are emitted
    **big-endian** (most significant first), and each limb is allocated as a
    witness tied to its bit LC by one enforcement — so both the limb layout and
    the constraint count (num_limbs witnesses + num_limbs enforcements per
    element) match the reference.
    """
    from .nonnative import get_limbs_representations, get_params

    all_bits = list(all_bits)
    if not all_bits:
        return []
    p = cs.fs.modulus
    params = get_params(
        target_fs.modulus_bit_size, cs.fs.modulus_bit_size, optimization_type
    )

    # Lookup table: limb representation of 2^j *in the target field* (mod.rs:33-42
    # doubles an F element, so powers wrap mod the target modulus).
    max_bits = max(len(bits) for bits in all_bits)
    lookup = []
    cur = 1
    for _ in range(max_bits):
        lookup.append(
            get_limbs_representations(
                cur, target_fs.modulus_bit_size, cs.fs.modulus_bit_size,
                optimization_type,
            )
        )
        cur = (cur * 2) % target_fs.modulus

    out = []
    for bits in all_bits:
        vals = [0] * params.num_limbs
        lcs = [LinearCombination() for _ in range(params.num_limbs)]
        for j, b in enumerate(bits):
            rep = lookup[j]
            if b.value:
                for k in range(params.num_limbs):
                    vals[k] += rep[k]
            for k in range(params.num_limbs):
                lcs[k] = lcs[k].plus(b.var.lc.scaled(rep[k] % p, p), p)
        limbs: List[FpVar] = []
        for k in range(params.num_limbs):
            gadget = FpVar.new_witness(cs, vals[k])
            diff = lcs[k].plus(gadget.lc.scaled(p - 1, p), p)
            cs.enforce(LinearCombination(), LinearCombination(), diff)
            limbs.append(gadget)
        out.append(limbs)
    return out


def nonnative_limbs_value(
    limbs: List[FpVar], bits_per_limb: int, target_fs: FieldSpec
) -> int:
    """Recombine **big-endian** limb witnesses into the target-field value."""
    acc = 0
    for limb in limbs:
        acc = (acc << bits_per_limb) + limb.value
    return acc % target_fs.modulus


class PoseidonSpongeVar:
    """The in-circuit Poseidon duplex sponge (poseidon/constraints.rs:19-291)."""

    def __init__(self, cs: ConstraintSystem, cfg: PoseidonConfig):
        self.cs = cs
        self.cfg = cfg
        zero = FpVar.constant(0, cfg.field)
        self.state: List[FpVar] = [zero] * cfg.t
        self.mode = ABSORBING
        self.index = 0

    # ---- permutation (constraints.rs:38-107) ----

    def _apply_s_box(self, state, is_full_round: bool):
        if is_full_round:
            for i in range(len(state)):
                state[i] = state[i].pow_by_constant(self.cfg.alpha)
        else:
            state[0] = state[0].pow_by_constant(self.cfg.alpha)

    def _apply_ark(self, state, round_number: int):
        for i in range(len(state)):
            state[i] = state[i] + FpVar.constant(self.cfg.ark[round_number][i], self.cfg.field)

    def _apply_mds(self, state):
        new_state = []
        for i in range(len(state)):
            cur = FpVar.constant(0, self.cfg.field)
            for j, elem in enumerate(state):
                cur = cur + elem.mul_constant(self.cfg.mds[i][j])
            new_state.append(cur)
        state[:] = new_state

    def permute(self):
        half = self.cfg.full_rounds // 2
        state = list(self.state)
        for r in range(half):
            self._apply_ark(state, r)
            self._apply_s_box(state, True)
            self._apply_mds(state)
        for r in range(half, half + self.cfg.partial_rounds):
            self._apply_ark(state, r)
            self._apply_s_box(state, False)
            self._apply_mds(state)
        for r in range(half + self.cfg.partial_rounds, self.cfg.rounds):
            self._apply_ark(state, r)
            self._apply_s_box(state, True)
            self._apply_mds(state)
        self.state = state

    # ---- duplex machine (identical control flow to the native sponge) ----

    def _absorb_internal(self, rate_start_index: int, elements: List[FpVar]):
        cfg = self.cfg
        remaining = list(elements)
        while True:
            if rate_start_index + len(remaining) <= cfg.rate:
                for i, elem in enumerate(remaining):
                    idx = cfg.capacity + i + rate_start_index
                    self.state[idx] = self.state[idx] + elem
                self.mode = ABSORBING
                self.index = rate_start_index + len(remaining)
                return
            num = cfg.rate - rate_start_index
            for i in range(num):
                idx = cfg.capacity + i + rate_start_index
                self.state[idx] = self.state[idx] + remaining[i]
            self.permute()
            remaining = remaining[num:]
            rate_start_index = 0

    def _squeeze_internal(self, rate_start_index: int, num: int) -> List[FpVar]:
        cfg = self.cfg
        out: List[FpVar] = []
        remaining = num
        while True:
            if rate_start_index + remaining <= cfg.rate:
                s = cfg.capacity + rate_start_index
                out.extend(self.state[s : s + remaining])
                self.mode = SQUEEZING
                self.index = rate_start_index + remaining
                return out
            n = cfg.rate - rate_start_index
            s = cfg.capacity + rate_start_index
            out.extend(self.state[s : s + n])
            if remaining != cfg.rate:  # same quirk as native (mod.rs:174-177)
                self.permute()
            remaining -= n
            rate_start_index = 0

    # ---- CryptographicSpongeVar surface ----

    def absorb(self, x):
        """Absorb a gadget value (constraints.rs:206-231)."""
        elems = to_sponge_field_elements_gadget(x, self.cs, self.cfg.field)
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

    def squeeze_field_elements(self, num: int) -> List[FpVar]:
        """constraints.rs:265-291."""
        if self.mode == ABSORBING:
            self.permute()
            return self._squeeze_internal(0, num)
        squeeze_index = self.index
        if squeeze_index == self.cfg.rate:
            self.permute()
            squeeze_index = 0
        return self._squeeze_internal(squeeze_index, num)

    def squeeze_bits(self, num_bits: int) -> List[Boolean]:
        """constraints.rs:249-263: low usable bits of each squeezed element."""
        fs = self.cfg.field
        usable = fs.modulus_bit_size - 1
        num_elements = -(-num_bits // usable)
        elems = self.squeeze_field_elements(num_elements)
        bits: List[Boolean] = []
        for e in elems:
            bits.extend(e.to_bits_le()[:usable])
        return bits[:num_bits]

    def squeeze_bytes(self, num_bytes: int) -> List[UInt8]:
        """constraints.rs:233-247: low usable bytes of each squeezed element."""
        fs = self.cfg.field
        usable = (fs.modulus_bit_size - 1) // 8
        num_elements = -(-num_bytes // usable)
        elems = self.squeeze_field_elements(num_elements)
        out: List[UInt8] = []
        for e in elems:
            out.extend(e.to_bytes()[:usable])
        return out[:num_bytes]

    def squeeze_nonnative_field_elements_with_sizes(
        self, target_fs: FieldSpec, sizes, optimization_type: str = "constraints"
    ) -> Tuple[List[List[FpVar]], List[List[Boolean]]]:
        """constraints/mod.rs:122-153: returns (limb gadgets, raw bit vectors)."""
        if len(sizes) == 0:
            return [], []
        per = [field_element_size_num_bits(s, target_fs) for s in sizes]
        bits = self.squeeze_bits(sum(per))
        dest_bits: List[List[Boolean]] = []
        pos = 0
        for n in per:
            dest_bits.append(bits[pos : pos + n])
            pos += n
        gadgets = bits_le_to_nonnative(
            self.cs, dest_bits, target_fs, optimization_type
        )
        return gadgets, dest_bits

    def squeeze_nonnative_field_elements(self, target_fs: FieldSpec, num: int):
        return self.squeeze_nonnative_field_elements_with_sizes(
            target_fs, [FULL] * num
        )

    def fork(self, domain: bytes) -> "PoseidonSpongeVar":
        """constraints/mod.rs:166-181: constant-domain absorb on a clone."""
        from .. import absorb as absorb_codec

        new = self.clone()
        payload = absorb_codec.to_sponge_bytes(
            absorb_codec.Usize(len(domain))
        ) + bytes(domain)
        elems = absorb_codec.to_sponge_field_elements(payload, self.cfg.field)
        new.absorb([FpVar.constant(e, self.cfg.field) for e in elems])
        return new

    def clone(self) -> "PoseidonSpongeVar":
        new = PoseidonSpongeVar(self.cs, self.cfg)
        new.state = list(self.state)
        new.mode = self.mode
        new.index = self.index
        return new
