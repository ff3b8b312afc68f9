"""Nonnative limb geometry matching ark-r1cs-std's ``get_params``.

The reference's ``bits_le_to_nonnative`` (reference src/constraints/
mod.rs:33-48) sizes nonnative limbs via ``get_params(F::MODULUS_BIT_SIZE,
CF::MODULUS_BIT_SIZE, OptimizationType)`` and decomposes values with
``AllocatedNonNativeFieldVar::get_limbs_representations`` — both from
ark-r1cs-std (``fields/nonnative/params.rs`` / ``allocated_field_var.rs``,
originally the arkworks ``nonnative`` crate).  This module is a faithful
re-implementation of that brute-force cost-model search and of the big-endian
limb decomposition, so the tracer's limb counts/sizes match what ark would
produce for the same (target, base) field pair.

Semantics mirrored exactly:
  * ``find_parameters`` scans every candidate ``bits_per_limb`` up to
    ``(base_bits - 1 - surfeit - 1) / 2 - 1`` (surfeit = 10) and keeps the
    cheapest under the chosen optimization's cost model (first minimum wins on
    ties, as in the Rust ``<`` comparison);
  * ``get_limbs_representations`` returns **big-endian** limbs (most
    significant first), each of ``bits_per_limb`` bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

CONSTRAINTS = "constraints"
WEIGHT = "weight"

_SURFEIT = 10


@dataclass(frozen=True)
class NonNativeFieldParams:
    """ark-r1cs-std ``NonNativeFieldParams``: limb count + bits per limb."""

    num_limbs: int
    bits_per_limb: int


def find_parameters(
    base_field_prime_length: int,
    target_field_prime_bit_length: int,
    optimization_type: str = CONSTRAINTS,
) -> NonNativeFieldParams:
    """Brute-force (num_limbs, bits_per_limb) search with ark's cost model."""
    found = False
    min_cost = 0
    best_limb_size = 0
    best_num_limbs = 0

    surfeit = _SURFEIT
    max_limb_size = (base_field_prime_length - 1 - surfeit - 1) // 2 - 1
    max_limb_size = min(max_limb_size, target_field_prime_bit_length)

    for limb_size in range(1, max_limb_size + 1):
        num_of_limbs = -(-target_field_prime_bit_length // limb_size)

        group_size = (
            base_field_prime_length - 1 - surfeit - 1 - 1 - limb_size + limb_size - 1
        ) // limb_size
        num_of_groups = -(-(2 * num_of_limbs - 1) // group_size)

        this_cost = 0
        if optimization_type == CONSTRAINTS:
            this_cost += 2 * num_of_limbs - 1  # product representation
            this_cost += target_field_prime_bit_length  # allocation of k
            this_cost += target_field_prime_bit_length + num_of_limbs  # alloc of r
            # group-wise equality check
            this_cost += (
                num_of_groups + (num_of_groups - 1) * (limb_size * 2 + surfeit) + 1
            )
        elif optimization_type == WEIGHT:
            this_cost += 6 * num_of_limbs * num_of_limbs
            this_cost += target_field_prime_bit_length * 3 + target_field_prime_bit_length
            this_cost += (
                target_field_prime_bit_length * 3
                + target_field_prime_bit_length
                + num_of_limbs
            )
            this_cost += num_of_limbs * num_of_limbs + 2 * (2 * num_of_limbs - 1)
            this_cost += (
                num_of_limbs
                + num_of_groups
                + 6 * num_of_groups
                + (num_of_groups - 1) * (2 * limb_size + surfeit) * 4
                + 2
            )
        else:
            raise ValueError(f"unknown optimization type: {optimization_type!r}")

        if not found or this_cost < min_cost:
            found = True
            min_cost = this_cost
            best_limb_size = limb_size
            best_num_limbs = num_of_limbs

    return NonNativeFieldParams(num_limbs=best_num_limbs, bits_per_limb=best_limb_size)


def get_params(
    target_field_size: int,
    base_field_size: int,
    optimization_type: str = CONSTRAINTS,
) -> NonNativeFieldParams:
    """ark-r1cs-std ``get_params`` (call site: constraints/mod.rs:44-48)."""
    return find_parameters(base_field_size, target_field_size, optimization_type)


def get_limbs_representations(
    value: int,
    target_field_size: int,
    base_field_size: int,
    optimization_type: str = CONSTRAINTS,
) -> List[int]:
    """Decompose a canonical target-field value into **big-endian** limbs.

    Mirrors ``AllocatedNonNativeFieldVar::get_limbs_representations_from_big_
    integer``: push the low ``bits_per_limb`` bits, shift, repeat, then reverse.
    """
    params = get_params(target_field_size, base_field_size, optimization_type)
    mask = (1 << params.bits_per_limb) - 1
    limbs = []
    cur = int(value)
    for _ in range(params.num_limbs):
        limbs.append(cur & mask)
        cur >>= params.bits_per_limb
    limbs.reverse()
    return limbs
