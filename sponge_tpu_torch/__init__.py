"""sponge_tpu_torch: the batched Poseidon sponge on PyTorch and CUDA.

The PyTorch port of ``sponge_tpu``, module for module: the same sponge,
transcript and hashing surface over ``(t, L, B)`` int32 Montgomery planes of
24-bit limbs, with the permutation in two hand-written CUDA kernels
(``csrc/poseidon_opt.cu``, ``csrc/poseidon_dense.cu``) and a plain PyTorch
version of each for CPU tensors.  It imports neither JAX nor ``sponge_tpu``.
"""

from .absorb import (
    I8,
    I16,
    I32,
    I64,
    I128,
    NONE,
    U8,
    U16,
    U32,
    U64,
    U128,
    Fp,
    Isize,
    Some,
    SWPoint,
    TEPoint,
    Usize,
    WithLength,
    field_cast,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from .fields import (
    BABYBEAR_FR,
    BLS12_377_FR,
    BLS12_381_FR,
    BLS12_381_FR_L13,
    BN254_FR,
    GOLDILOCKS_FR,
    KOALABEAR_FR,
    MERSENNE31_FR,
    FieldSpec,
    get_field,
)
from .lazy import LazyPoseidonSponge
from .poseidon.config import PoseidonConfig
from .poseidon.oracle import (
    ABSORBING,
    FULL,
    SQUEEZING,
    OraclePoseidonSponge,
    SpongeState,
    Truncated,
)
from .poseidon.params import (
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
    poseidon_test_fixture,
)
from .poseidon.permutation import (
    PoseidonPermutation,
    batched_permute,
    permute,
    zero_state,
)
from .sponge import Batched, PoseidonSponge
from .transcript import Absorb as TranscriptAbsorb
from .transcript import SqueezeNative as TranscriptSqueeze
from .transcript import compile_transcript

__all__ = [
    "ABSORBING",
    "BABYBEAR_FR",
    "BLS12_377_FR",
    "BLS12_381_FR",
    "BLS12_381_FR_L13",
    "BN254_FR",
    "Batched",
    "FULL",
    "FieldSpec",
    "Fp",
    "GOLDILOCKS_FR",
    "I8",
    "I16",
    "I32",
    "I64",
    "I128",
    "Isize",
    "KOALABEAR_FR",
    "LazyPoseidonSponge",
    "MERSENNE31_FR",
    "NONE",
    "OraclePoseidonSponge",
    "PoseidonConfig",
    "PoseidonPermutation",
    "PoseidonSponge",
    "SQUEEZING",
    "SWPoint",
    "Some",
    "SpongeState",
    "TEPoint",
    "TranscriptAbsorb",
    "TranscriptSqueeze",
    "Truncated",
    "U8",
    "U16",
    "U32",
    "U64",
    "U128",
    "Usize",
    "WithLength",
    "batched_permute",
    "compile_transcript",
    "field_cast",
    "find_poseidon_ark_and_mds",
    "get_default_poseidon_parameters",
    "get_field",
    "permute",
    "poseidon_test_fixture",
    "to_sponge_bytes",
    "to_sponge_field_elements",
    "zero_state",
]
