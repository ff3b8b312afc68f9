"""The port's data-parallel layer (``sponge_tpu_torch.parallel``) in a real
four-process gloo group, against the port's unsharded functions on the
same planes; ``test_torch_parallel_jax.py`` holds those unsharded results
against the JAX package's sharded functions on ``make_mesh(4)``.

One group of four processes (``test_torch_parallel_worker.py``) runs every
sharded function once for the module: permute, state, transcript, the
narrow, wide and Jive roots (and a tree with exactly 2 leaves per rank, the
cutover edge), verification with one tampered lane, the errors, and
``scaling_report`` honest and with one rank's permutation corrupted.  Each
check below reads those results.  The configs are the conftest's 35-bit
ones (t = 3; t = 4 for Jive).  Equality is exact.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_poseidon_config
from torch.distributed.tensor import Replicate, Shard

import sponge_tpu_torch as st
from sponge_tpu_torch import hash as h
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor
from sponge_tpu_torch.parallel import make_mesh, multihost
from sponge_tpu_torch.transcript import Absorb, SqueezeNative

WORLD = 4
WORKER = Path(__file__).with_name("test_torch_parallel_worker.py")
JCFG, JCFG4 = tiny_poseidon_config(), tiny_poseidon_config(t=4)
CFG, CFG4 = interop.config_from_jax(JCFG), interop.config_from_jax(JCFG4)
FS = CFG.field
P = FS.modulus
B = 16  # permutation and transcript lanes, 4 per rank
N = 32  # narrow leaves
STEPS = (Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(3))
IDX = torch.tensor([0, 3, 8, 13, 17, 22, 30, 31])  # proofs, one tampered
TAMPERED = 5


def rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return np.asarray([int(rng.integers(0, 2**63)) % P for _ in range(int(np.prod(shape)))],
                      dtype=object).reshape(shape)


def both(vals):
    """(..., B) ints -> (JAX Montgomery plane, port plane)."""
    vals = np.asarray(vals, dtype=object)
    flat = vals.reshape(-1, vals.shape[-1])
    jplane = np.stack([JCFG.field.ints_to_mont_plane(row) for row in flat])
    jplane = jplane.reshape(vals.shape[:-1] + jplane.shape[-2:])
    port = ints_to_mont_tensor(FS, flat.tolist(), "cpu")
    return jnp.asarray(jplane), port.reshape(vals.shape[:-1] + port.shape[-2:])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def planes() -> dict:
    """Every input plane of the module as (JAX plane, port plane), from
    fixed seeds, and the narrow tree's proofs with one tampered leaf."""
    p = dict(
        state=both(rand(1, CFG.t, B)), elems=both(rand(2, 4, B)), leaves=both(rand(3, N)),
        edge=both(rand(4, 2 * WORLD)), wide=both(rand(5, 2, N // 2)), jive=both(rand(6, 2, N // 2)),
    )
    levels = h.merkle_tree(CFG, p["leaves"][1])
    proof_leaves = p["leaves"][1][:, IDX].clone()
    proof_leaves[:, TAMPERED] = p["leaves"][1][:, 0]
    p.update(root=levels[-1][:, 0], proof_leaves=proof_leaves, paths=h.merkle_open_batch(levels, IDX))
    return p


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the group, compute the unsharded results while it runs, collect."""
    out = tmp_path_factory.mktemp("gloo4")
    p = planes()
    torch.save(dict(cfg=CFG, cfg4=CFG4, state=p["state"][1], steps=STEPS, elems=p["elems"][1],
                    leaves=p["leaves"][1], edge_leaves=p["edge"][1], wide_leaves=p["wide"][1],
                    jive_leaves=p["jive"][1], root=p["root"], proof_leaves=p["proof_leaves"],
                    paths=p["paths"], indices=IDX, batch_per_device=16),
               out / "inputs.pt")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    try:
        want = unsharded(p)
        logs = [proc.communicate(timeout=180)[0].decode() for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r}:\n{log}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, want


def unsharded(p) -> dict:
    """The port's unsharded result of every sharded function on ``planes()``."""
    return dict(
        permute=st.batched_permute(CFG, p["state"][1]),
        transcript=st.compile_transcript(CFG, STEPS)(p["elems"][1]),
        root=h.merkle_root(CFG, p["leaves"][1]),
        edge_root=h.merkle_root(CFG, p["edge"][1]),
        wide_root=h.merkle_root_wide(CFG, p["wide"][1]),
        jive_root=h.merkle_root_jive(CFG4, p["jive"][1]),
        verify=h.merkle_verify_batch(CFG, p["root"], p["proof_leaves"], p["paths"], IDX),
    )


def gathered(ranks, key):
    return torch.cat([r[key] for r in ranks], dim=-1)


def test_children_import_no_jax(run):
    ranks, _ = run
    assert all(r["modules"] == [] for r in ranks)


def test_mesh_is_one_data_axis_over_the_group(run):
    ranks, _ = run
    assert [r["mesh"] for r in ranks] == [("cpu", ("data",), WORLD, i) for i in range(WORLD)]
    assert all(r["placements"] == ([Shard(2)], [Shard(1)], [Replicate()]) for r in ranks)


def test_sharded_permute(run):
    ranks, want = run
    assert [tuple(r["permute"].shape) for r in ranks] == [(CFG.t, FS.nlimbs, B // WORLD)] * WORLD
    assert torch.equal(gathered(ranks, "permute"), want["permute"])


def test_sharded_state(run):
    ranks, _ = run
    assert all(torch.equal(r["state"], st.zero_state(CFG, B // WORLD, "cpu")) for r in ranks)


def test_sharded_transcript(run):
    ranks, want = run
    assert torch.equal(gathered(ranks, "transcript"), want["transcript"])


@pytest.mark.parametrize("key", ["root", "edge_root", "wide_root", "jive_root"],
                         ids=["narrow", "two_leaves_per_rank", "wide", "jive"])
def test_sharded_roots(run, key):
    """Every rank holds the root of the whole tree."""
    ranks, want = run
    assert all(torch.equal(r[key], want[key]) for r in ranks)


def test_sharded_verify_fails_the_tampered_lane_alone(run):
    ranks, want = run
    got = gathered(ranks, "verify").tolist()
    assert got == [i != TAMPERED for i in range(len(IDX))] == want["verify"].tolist()


@pytest.mark.parametrize("case,match", [
    ("uneven_chunks", "divisible by the mesh size"),
    ("not_power_of_two", "power of two"),
    ("index_out_of_range", "out of range"),
    ("indivisible_batch", "not divisible by the mesh size"),
    ("transcript_rows", "the schedule absorbs 4"),
    ("sub_mesh", "spans every rank"),
    ("cuda_mesh_on_gloo", "no CUDA device"),
    ("initialize_twice", "already joined"),
    ("odd_width_jive", "Jive_2"),
])
def test_errors_raise_on_every_rank(run, case, match):
    ranks, _ = run
    assert all(r["errors"][case] is not None and match in r["errors"][case] for r in ranks)


def test_scaling_report(run):
    ranks, _ = run
    for r in ranks:
        rep = r["report"]
        assert rep["devices"] == WORLD and rep["perms_per_sec"] > 0
        assert rep["perms_per_sec_per_device"] == pytest.approx(rep["perms_per_sec"] / WORLD)


def test_scaling_report_refuses_when_one_rank_is_wrong(run):
    ranks, _ = run
    assert all(r["refused"] is not None and "PARITY FAILURE" in r["refused"] for r in ranks)
    assert "local lane 0" in ranks[1]["refused"]
    assert all("another rank" in r["refused"] for i, r in enumerate(ranks) if i != 1)


def test_cuda_is_the_default_and_is_never_replaced_by_the_cpu(monkeypatch):
    """With no GPU, the default CUDA mesh and group raise; nothing falls back
    to gloo or the CPU.  A CPU mesh needs a group first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_mesh(device_type="tpu")
