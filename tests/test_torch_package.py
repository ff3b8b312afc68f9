"""The port's package boundary: it imports neither JAX nor ``sponge_tpu``,
builds nothing on import, keys its kernel build on the sources and reports
nvcc's errors, and the public surface has the JAX package's names."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import sponge_tpu
import sponge_tpu_torch
from sponge_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys, sponge_tpu_torch, sponge_tpu_torch.hash, sponge_tpu_torch.interop\n"
        "import sponge_tpu_torch.ops.poseidon2, sponge_tpu_torch.ops.rescue\n"
        "import sponge_tpu_torch.poseidon2.permutation, sponge_tpu_torch.rescue.permutation\n"
        "import sponge_tpu_torch.ops.gmimc, sponge_tpu_torch.ops.griffin, sponge_tpu_torch.ops.anemoi\n"
        "import sponge_tpu_torch.gmimc.permutation, sponge_tpu_torch.griffin.permutation\n"
        "import sponge_tpu_torch.anemoi.permutation, sponge_tpu_torch.monolith.permutation\n"
        "import sponge_tpu_torch.ops.monolith, sponge_tpu_torch.ops.probe\n"
        "from sponge_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sponge_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_public_names_mirror_jax_package():
    ported = {
        "PoseidonSponge", "LazyPoseidonSponge", "OraclePoseidonSponge", "PoseidonConfig",
        "get_default_poseidon_parameters", "find_poseidon_ark_and_mds", "poseidon_test_fixture",
        "compile_transcript", "TranscriptAbsorb", "TranscriptSqueeze", "Batched", "FieldSpec",
        "BLS12_381_FR", "BLS12_381_FR_L13", "BN254_FR", "BLS12_377_FR", "GOLDILOCKS_FR",
        "BABYBEAR_FR", "MERSENNE31_FR", "KOALABEAR_FR", "Fp", "U64", "Usize", "WithLength",
        "Poseidon2Config", "OraclePoseidon2Sponge", "get_default_poseidon2_parameters",
        "generate_poseidon2_parameters", "RescueConfig", "OracleRescueSponge",
        "get_default_rescue_parameters", "generate_rescue_parameters", "GmimcConfig",
        "OracleGmimcSponge", "get_default_gmimc_parameters", "generate_gmimc_parameters",
        "GriffinConfig", "OracleGriffinSponge", "get_default_griffin_parameters",
        "generate_griffin_parameters", "AnemoiConfig", "OracleAnemoiSponge",
        "get_default_anemoi_parameters", "generate_anemoi_parameters", "MonolithConfig",
        "OracleMonolithSponge", "get_default_monolith_parameters", "generate_monolith_parameters",
    }
    for name in ported:
        assert hasattr(sponge_tpu, name) and hasattr(sponge_tpu_torch, name), name


def test_build_is_keyed_by_sources_and_raises_with_nvcc_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.library_path()
    (csrc / "mont.cuh").write_text((csrc / "mont.cuh").read_text() + "\n// edited\n")
    assert _build.library_path() != before
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fatal: stand-in compiler' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="stand-in compiler"):
        _build.build()
    assert not _build.library_path().exists()
