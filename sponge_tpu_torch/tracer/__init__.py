"""Constraint-tracing mirror of the sponge (the reference's `r1cs` feature).

Run the duplex sponge over symbolic ``FpVar`` values to record an R1CS, check
witness satisfaction, and count constraints — the capability the reference
provides via ark-r1cs-std/ark-relations (SURVEY.md L5), rebuilt as an
operator-overloaded tracer field.  Counterpart of ``sponge_tpu/tracer``: pure
Python and symbolic, so both packages record the same constraint system.
"""

from .absorb_gadget import (
    OptionVar,
    SWPointVar,
    TEPointVar,
    absorb_gadget,
    bytes_to_field_elements_gadget,
    collect_sponge_field_elements_gadget,
    to_sponge_bytes_gadget,
    to_sponge_field_elements_gadget,
)
from .nonnative import (
    NonNativeFieldParams,
    get_limbs_representations,
    get_params,
)
from .r1cs import Boolean, ConstraintSystem, FpVar, LinearCombination, UInt8
from .sponge_var import (
    PoseidonSpongeVar,
    bits_le_to_nonnative,
    nonnative_limbs_value,
)


def gadget_of(sponge_cls):
    """``SpongeWithGadget`` analogue (reference src/constraints/mod.rs:93-96):
    maps a native sponge class to its in-circuit mirror."""
    from ..sponge import PoseidonSponge

    mapping = {PoseidonSponge: PoseidonSpongeVar}
    try:
        return mapping[sponge_cls]
    except KeyError:
        raise TypeError(f"no gadget registered for {sponge_cls!r}") from None


__all__ = [
    "OptionVar",
    "SWPointVar",
    "TEPointVar",
    "gadget_of",
    "NonNativeFieldParams",
    "get_limbs_representations",
    "get_params",
    "to_sponge_bytes_gadget",
    "absorb_gadget",
    "collect_sponge_field_elements_gadget",
    "Boolean",
    "ConstraintSystem",
    "FpVar",
    "LinearCombination",
    "UInt8",
    "PoseidonSpongeVar",
    "bits_le_to_nonnative",
    "nonnative_limbs_value",
    "bytes_to_field_elements_gadget",
    "to_sponge_field_elements_gadget",
]
