"""Plonky3's two hash modes on the port (``hash.padding_free_hash``, the
truncated-permutation tree and its batched verification) at SP1's BabyBear
Poseidon2 width 16, against the benchmark's plain reference
(``spongebench/reference/poseidon2.py``), on seeded random inputs at small
sizes on the CPU; and the same modes over other families' configs against
their scalar oracles."""

import random

import pytest
import torch

import sponge_tpu_torch as st
from sponge_tpu_torch import hash as sthash
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.poseidon.permutation import overwrite_rows
from spongebench.reference.poseidon2 import Poseidon2, padding_free_hash, truncated_compress

FS = st.BABYBEAR_FR
P = FS.modulus
CFG = st.get_default_poseidon2_parameters(FS, 8)
REF = Poseidon2.generate(P, 16, 7, 8, 13)
D = 8  # digest elements: t / 2


def control_config():
    """The benchmark family's control: the last internal round dropped."""
    from spongebench.harness import BENCH_DIR, _load_module

    family = _load_module(BENCH_DIR / "families" / "poseidon2.py")
    return family.control_config(st, {"field": FS.name, "rate": 8, "modulus": P, "width": 16, "capacity": 8,
                                      "alpha": 7, "full_rounds": 8, "partial_rounds": 13})


def random_rows(seed, k, lanes, p=P):
    """[k][lanes] random field elements, the first lanes' edge values."""
    rng = random.Random(seed)
    rows = [[rng.randrange(p) for _ in range(lanes)] for _ in range(k)]
    for i, v in enumerate((0, 1, p - 1)):
        if i < lanes and k:
            rows[0][i] = v
    return rows


def columns(rows):
    return [list(c) for c in zip(*rows)]


def test_reference_constants_are_the_ports_default():
    assert (CFG.t, CFG.rate, CFG.capacity, CFG.alpha, CFG.full_rounds, CFG.partial_rounds) == (16, 8, 8, 7, 8, 13)
    assert REF.external_rc == CFG.external_rc
    assert REF.internal_rc == CFG.internal_rc
    assert REF.diag == CFG.mat_i_diag
    assert REF.mat_e == CFG.mat_e


@pytest.mark.parametrize("lanes", [1, 5, 16])
def test_permutation_equals_the_reference(lanes):
    rows = random_rows(lanes, 16, lanes)
    got = st.batched_permute(CFG, ints_to_mont_tensor(FS, rows, "cpu"))
    assert columns(mont_tensor_to_ints(FS, got)) == [REF.permute(c) for c in columns(rows)]


@pytest.mark.parametrize("k", [64, 61, 8, 3, 0])
def test_padding_free_hash_equals_the_reference(k):
    """A whole last chunk (64, 8), a part one (61, 3), and no elements,
    which Plonky3 hashes to the zero state's rate without a permutation."""
    lanes = 6
    rows = random_rows(100 + k, k, lanes)
    plane = ints_to_mont_tensor(FS, rows, "cpu") if k else torch.zeros((0, FS.nlimbs, lanes), dtype=torch.int32)
    got = sthash.padding_free_hash(CFG, plane, D)
    assert got.shape == (D, FS.nlimbs, lanes)
    want = [padding_free_hash(REF, c, 8, D) for c in (columns(rows) if k else [[]] * lanes)]
    assert columns(mont_tensor_to_ints(FS, got)) == want


def test_padding_free_hash_keeps_the_state_past_a_short_chunk():
    """A part chunk overwrites only its own rows: the rate rows past it
    keep the previous permutation's values, unlike an all-zero pad."""
    rows = random_rows(7, 11, 2)
    state = REF.permute(columns(rows)[0][:8] + [0] * 8)
    want = REF.permute(columns(rows)[0][8:] + state[3:])[:8]
    got = sthash.padding_free_hash(CFG, ints_to_mont_tensor(FS, rows, "cpu"), 8)
    assert columns(mont_tensor_to_ints(FS, got))[0] == want


def leaves_and_tree(n, seed):
    digests = random_rows(seed, D, n)
    leaves = ints_to_mont_tensor(FS, digests, "cpu")
    return leaves, columns(digests), sthash.merkle_tree_truncated(CFG, leaves)


def test_merkle_tree_truncated_equals_the_reference():
    """Every node of every level over 2^5 leaves."""
    leaves, level, levels = leaves_and_tree(32, 3)
    assert [lv.shape[-1] for lv in levels] == [32, 16, 8, 4, 2, 1]
    assert torch.equal(levels[0], leaves)
    for got in levels[1:]:
        level = [truncated_compress(REF, level[2 * i], level[2 * i + 1]) for i in range(len(level) // 2)]
        assert columns(mont_tensor_to_ints(FS, got)) == level
    assert torch.equal(sthash.merkle_root_truncated(CFG, leaves), levels[-1][..., 0])


def test_merkle_verify_batch_truncated():
    """True paths verify, at both ends and between; a flipped sibling fails
    its own lane only."""
    leaves, _, levels = leaves_and_tree(32, 4)
    idx = [0, 31, 5, 18]
    paths = sthash.merkle_open_batch_wide(levels, idx)
    root, opened = levels[-1][..., 0], leaves[..., idx]
    assert sthash.merkle_verify_batch_truncated(CFG, root, opened, paths, idx).tolist() == [True] * 4
    bad = paths.clone()
    bad[2, 3, 0, 1] ^= 1
    assert sthash.merkle_verify_batch_truncated(CFG, root, opened, bad, idx).tolist() == [True, False, True, True]


def test_control_config_differs_from_the_reference():
    """R_P - 1, the benchmark's control: every lane's digest and node
    differ from the reference's."""
    cfg = control_config()
    assert cfg.partial_rounds == 12 and len(cfg.internal_rc) == 12
    rows = random_rows(9, 64, 4)
    got = columns(mont_tensor_to_ints(FS, sthash.padding_free_hash(cfg, ints_to_mont_tensor(FS, rows, "cpu"), D)))
    assert all(g != padding_free_hash(REF, c, 8, D) for g, c in zip(got, columns(rows)))
    leaves, level, _ = leaves_and_tree(4, 5)
    nodes = columns(mont_tensor_to_ints(FS, sthash.merkle_tree_truncated(cfg, leaves)[1]))
    assert all(g != truncated_compress(REF, level[2 * i], level[2 * i + 1]) for i, g in enumerate(nodes))


def near_bound_rows(k, lanes):
    """Every element p - 1 in the even lanes, 0 in the odd ones."""
    return [[P - 1 if b % 2 == 0 else 0 for b in range(lanes)] for _ in range(k)]


@pytest.mark.parametrize("kind", ["random", "near-bound"])
@pytest.mark.parametrize("k", [64, 13, 5])
def test_overwrite_sponge_equals_the_loop_and_the_reference(k, kind):
    """The modes on kernel 3's overwrite sponge (``Poseidon2Permutation``
    ``overwrite``, its plain version here: one call a row set, one a level)
    equal the unfused loop ("plain" backend) and the reference: the leaf
    digests, and every node of the tree over them."""
    lanes = 8
    rows = random_rows(200 + k, k, lanes) if kind == "random" else near_bound_rows(k, lanes)
    plane = ints_to_mont_tensor(FS, rows, "cpu")
    assert st.Poseidon2Permutation(CFG, "cpu").overwrites
    fused = sthash.padding_free_hash(CFG, plane, D)
    assert torch.equal(fused, sthash.padding_free_hash(CFG, plane, D, "plain"))
    level = [padding_free_hash(REF, c, 8, D) for c in columns(rows)]
    assert columns(mont_tensor_to_ints(FS, fused)) == level
    levels = sthash.merkle_tree_truncated(CFG, fused)
    for got, loop in zip(levels, sthash.merkle_tree_truncated(CFG, fused, "plain")):
        assert torch.equal(got, loop)
    for got in levels[1:]:
        level = [truncated_compress(REF, level[2 * i], level[2 * i + 1]) for i in range(len(level) // 2)]
        assert columns(mont_tensor_to_ints(FS, got)) == level


def test_overwrite_sponge_reads_strided_views():
    """A node's children read where they lie, as the even and odd lanes of
    the level below (lane stride 2), equal their contiguous copies; a
    plain permutation is one chunk of t rows, every row kept."""
    from sponge_tpu_torch.ops.poseidon2 import overwrite_permute_p2

    consts = st.Poseidon2Permutation(CFG, "cpu").consts
    level = ints_to_mont_tensor(FS, random_rows(12, D, 16), "cpu")
    left, right = level[..., 0::2], level[..., 1::2]
    assert left.stride()[-1] == 2 and not left.is_contiguous()
    got = overwrite_permute_p2(CFG, consts, (left, right), 16, D)
    assert torch.equal(got, sthash.truncated_compress_pairs(CFG, left.contiguous(), right.contiguous(), "plain"))
    state = ints_to_mont_tensor(FS, random_rows(13, 16, 5), "cpu")
    assert torch.equal(overwrite_permute_p2(CFG, consts, (state,), 16, 16), st.batched_permute(CFG, state, "plain"))
    assert columns(mont_tensor_to_ints(FS, got)) == [
        truncated_compress(REF, a, b) for a, b in zip(columns(mont_tensor_to_ints(FS, left)),
                                                      columns(mont_tensor_to_ints(FS, right)))]


def _unpermuted(real):
    return lambda self, views, width, out_rows: torch.cat(views)[:out_rows].clone()


def _half_left_out(real):
    def overwrite(self, views, width, out_rows):
        half = views[0].shape[-1] // 2
        done = real(self, tuple(v[..., :half] for v in views), width, out_rows)
        return torch.cat([done, torch.cat(views)[:out_rows, :, half:]], -1)

    return overwrite


def _no_carry(real):
    def overwrite(self, views, width, out_rows):  # each chunk from a zero state: the last alone counts
        rows = torch.cat(views)
        return real(self, (rows[(rows.shape[0] - 1) // width * width :],), width, out_rows)

    return overwrite


@pytest.mark.parametrize("fault", [_unpermuted, _half_left_out, _no_carry])
def test_a_broken_overwrite_sponge_makes_the_mmcs_cell_not_correct(monkeypatch, fault):
    """A fault planted in the module's overwrite sponge
    (``Poseidon2Permutation.overwrite``, the launch the MMCS cell's leaf
    hash and tree take) reaches the cell's timed path, and its comparison
    with the plain reference reads not correct: the sponge's rows left
    unpermuted, half the lanes left out, the state not carried from chunk
    to chunk."""
    from spongebench.tests.helpers import tiny_run

    from sponge_tpu_torch.poseidon2.permutation import Poseidon2Permutation

    calls = []
    broken = fault(Poseidon2Permutation.overwrite)

    def planted(self, *args):
        calls.append(args[1:])
        return broken(self, *args)

    monkeypatch.setattr(Poseidon2Permutation, "overwrite", planted)
    out = tiny_run("bb-mmcs-commit-2p23", leaves_log2=3)
    assert (8, D) in calls and (16, D) in calls  # the leaf hash's launch and the tree's
    assert out["correct"] is False
    assert out["checks"]["leaf_mismatches"]["value"] > 0


def test_the_modes_refuse_what_they_cannot_compute():
    leaves = torch.zeros((4, FS.nlimbs, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="t = 2"):
        sthash.truncated_compress_pairs(CFG, leaves, leaves)
    for outputs in (0, 9):
        with pytest.raises(ValueError, match="num_outputs"):
            sthash.padding_free_hash(CFG, leaves, outputs)
    with pytest.raises(ValueError, match="pass the rate"):
        overwrite_rows(CFG, st.zero_state(CFG, 2, "cpu"), torch.zeros((9, FS.nlimbs, 2), dtype=torch.int32))


# Other families' configs drive the same calls: (config, elements hashed).
OTHERS = {
    "poseidon-goldilocks-t12": (lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8), 19),
    "monolith-goldilocks-t12": (lambda: st.get_default_monolith_parameters(st.GOLDILOCKS_FR), 16),
    "poseidon2-koalabear-t16": (lambda: st.get_default_poseidon2_parameters(st.KOALABEAR_FR, 8), 20),
}


def oracle_permute(cfg, state):
    sponge = cfg.oracle_sponge() if hasattr(cfg, "oracle_sponge") else st.OraclePoseidonSponge(cfg)
    sponge.state = list(state)
    sponge.permute()
    return list(sponge.state)


@pytest.mark.parametrize("name", list(OTHERS))
def test_modes_over_other_families_equal_their_oracles(name):
    make, k = OTHERS[name]
    cfg = make()
    fs, t, rate, d = cfg.field, cfg.t, cfg.rate, cfg.t // 2
    rows = random_rows(11, k, 3, fs.modulus)
    got = sthash.padding_free_hash(cfg, ints_to_mont_tensor(fs, rows, "cpu"), d)
    want = []
    for col in columns(rows):
        state = [0] * t
        for lo in range(0, k, rate):
            chunk = col[lo : lo + rate]
            state = oracle_permute(cfg, chunk + state[len(chunk):])
        want.append(state[:d])
    assert columns(mont_tensor_to_ints(fs, got)) == want
    level = sthash.merkle_tree_truncated(cfg, torch.cat([got, got[:, :, :1]], -1))[1]
    assert columns(mont_tensor_to_ints(fs, level)) == [oracle_permute(cfg, want[0] + want[1])[:d],
                                                       oracle_permute(cfg, want[2] + want[0])[:d]]
