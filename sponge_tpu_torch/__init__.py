"""sponge_tpu_torch: the batched Poseidon sponge on PyTorch and CUDA.

The PyTorch port of ``sponge_tpu``, module for module: the same sponge,
transcript and hashing surface over ``(t, L, B)`` int32 Montgomery planes of
24-bit limbs.  The permutations run in hand-written CUDA kernels: Poseidon
(``csrc/poseidon_opt.cu``, ``csrc/poseidon_dense.cu``), Poseidon2
(``csrc/poseidon2.cu``), Rescue-Prime (``csrc/rescue.cu``), GMiMC-erf
(``csrc/gmimc.cu``), Griffin-pi (``csrc/griffin.cu``), Anemoi
(``csrc/anemoi.cu``) and Monolith (``csrc/monolith.cu``), each with a plain
PyTorch version for CPU tensors.
Every family's config drives every entry point a ``PoseidonConfig`` does.
``sponge_tpu_torch.parallel`` shards the lanes over a ``torch.distributed``
group; ``checkpoint`` and ``utils.profiling`` save state and trace runs.
The verifier's side runs on the host: the ``Host*Sponge`` classes and
``host_run_schedule`` (``poseidon/host.py``, C++ in ``csrc/host/``, built
with the system compiler at first use); ``tracer`` records a sponge's R1CS
and ``examples`` holds three runnable walk-throughs.
It imports neither JAX nor ``sponge_tpu``.
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
    collect_sponge_bytes,
    collect_sponge_field_elements,
    field_cast,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from .anemoi.config import AnemoiConfig
from .anemoi.oracle import OracleAnemoiSponge
from .anemoi.params import (
    anemoi_default_rounds,
    generate_anemoi_parameters,
    get_default_anemoi_parameters,
)
from .anemoi.permutation import AnemoiPermutation, batched_anemoi_permute
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
from .gmimc.config import GmimcConfig
from .gmimc.oracle import OracleGmimcSponge
from .gmimc.params import (
    generate_gmimc_parameters,
    get_default_gmimc_parameters,
    gmimc_default_rounds,
)
from .gmimc.permutation import GmimcPermutation, batched_gmimc_permute
from .griffin.config import GriffinConfig, is_quadratic_nonresidue
from .griffin.oracle import OracleGriffinSponge
from .griffin.params import (
    generate_griffin_parameters,
    get_default_griffin_parameters,
    griffin_default_rounds,
)
from .griffin.permutation import GriffinPermutation, batched_griffin_permute
from .lazy import LazyPoseidonSponge
from .monolith.config import MonolithConfig
from .monolith.oracle import OracleMonolithSponge
from .monolith.params import generate_monolith_parameters, get_default_monolith_parameters
from .monolith.permutation import MonolithPermutation, batched_monolith_permute
from .poseidon.config import PoseidonConfig
from .poseidon.host import (
    HostAnemoiSponge,
    HostGmimcSponge,
    HostGriffinSponge,
    HostMonolithSponge,
    HostPoseidon2Sponge,
    HostPoseidonSponge,
    HostRescueSponge,
    host_available,
    host_run_schedule,
)
from .poseidon.oracle import (
    ABSORBING,
    FULL,
    SQUEEZING,
    OraclePoseidonSponge,
    SpongeState,
    Truncated,
    field_element_size_num_bits,
    field_element_size_sum,
)
from .poseidon.params import (
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
    poseidon_test_fixture,
    register_default_table,
)
from .poseidon.permutation import (
    PoseidonPermutation,
    batched_permute,
    permute,
    zero_state,
)
from .poseidon2.config import Poseidon2Config
from .poseidon2.oracle import OraclePoseidon2Sponge
from .poseidon2.params import generate_poseidon2_parameters, get_default_poseidon2_parameters
from .poseidon2.permutation import Poseidon2Permutation, batched_permute2
from .rescue.config import RescueConfig
from .rescue.oracle import OracleRescueSponge
from .rescue.params import (
    generate_rescue_parameters,
    get_default_rescue_parameters,
    get_rpo_parameters,
    rescue_round_count,
    smallest_alpha,
)
from .rescue.permutation import RescuePermutation, batched_rescue_permute
from .sponge import Batched, PoseidonSponge
from .transcript import Absorb as TranscriptAbsorb
from .transcript import SqueezeNative as TranscriptSqueeze
from .transcript import compile_transcript

__all__ = [
    "ABSORBING",
    "anemoi_default_rounds",
    "AnemoiConfig",
    "AnemoiPermutation",
    "BABYBEAR_FR",
    "Batched",
    "batched_anemoi_permute",
    "batched_gmimc_permute",
    "batched_griffin_permute",
    "batched_monolith_permute",
    "batched_permute",
    "batched_permute2",
    "batched_rescue_permute",
    "BLS12_377_FR",
    "BLS12_381_FR",
    "BLS12_381_FR_L13",
    "BN254_FR",
    "collect_sponge_bytes",
    "collect_sponge_field_elements",
    "compile_transcript",
    "field_cast",
    "field_element_size_num_bits",
    "field_element_size_sum",
    "FieldSpec",
    "find_poseidon_ark_and_mds",
    "Fp",
    "FULL",
    "generate_anemoi_parameters",
    "generate_gmimc_parameters",
    "generate_griffin_parameters",
    "generate_monolith_parameters",
    "generate_poseidon2_parameters",
    "generate_rescue_parameters",
    "get_default_anemoi_parameters",
    "get_default_gmimc_parameters",
    "get_default_griffin_parameters",
    "get_default_monolith_parameters",
    "get_default_poseidon2_parameters",
    "get_default_poseidon_parameters",
    "get_default_rescue_parameters",
    "get_rpo_parameters",
    "get_field",
    "gmimc_default_rounds",
    "GmimcConfig",
    "GmimcPermutation",
    "GOLDILOCKS_FR",
    "griffin_default_rounds",
    "GriffinConfig",
    "GriffinPermutation",
    "host_available",
    "host_run_schedule",
    "HostAnemoiSponge",
    "HostGmimcSponge",
    "HostGriffinSponge",
    "HostMonolithSponge",
    "HostPoseidon2Sponge",
    "HostPoseidonSponge",
    "HostRescueSponge",
    "I128",
    "I16",
    "I32",
    "I64",
    "I8",
    "is_quadratic_nonresidue",
    "Isize",
    "KOALABEAR_FR",
    "LazyPoseidonSponge",
    "MERSENNE31_FR",
    "MonolithConfig",
    "MonolithPermutation",
    "NONE",
    "OracleAnemoiSponge",
    "OracleGmimcSponge",
    "OracleGriffinSponge",
    "OracleMonolithSponge",
    "OraclePoseidon2Sponge",
    "OraclePoseidonSponge",
    "OracleRescueSponge",
    "permute",
    "Poseidon2Config",
    "Poseidon2Permutation",
    "poseidon_test_fixture",
    "PoseidonConfig",
    "PoseidonPermutation",
    "PoseidonSponge",
    "rescue_round_count",
    "register_default_table",
    "RescueConfig",
    "RescuePermutation",
    "smallest_alpha",
    "Some",
    "SpongeState",
    "SQUEEZING",
    "SWPoint",
    "TEPoint",
    "to_sponge_bytes",
    "to_sponge_field_elements",
    "TranscriptAbsorb",
    "TranscriptSqueeze",
    "Truncated",
    "U128",
    "U16",
    "U32",
    "U64",
    "U8",
    "Usize",
    "WithLength",
    "zero_state",
]
