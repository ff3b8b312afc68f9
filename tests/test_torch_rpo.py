"""Rescue Prime Optimized (Miden's RPO256) on the port: ``get_rpo_parameters``,
kernel 5's MDS-first order in its plain version and the oracle, Miden's
length-tagged overwrite sponge (``hash.rpo_hash_elements``), the merge tree
(``hash.merkle_tree_wide``), the static value bound, the benchmark's
``gl-miden-commit-2p21`` cell and its judge, against the benchmark's plain
reference (``spongebench/reference/rescue.py``), on seeded random inputs at
small sizes on the CPU.  The card test holds kernel 5 to its plain version
on the card and skips without one.  This file imports nothing of JAX."""

import dataclasses
import random
import re
import types
from collections import namedtuple

import pytest
import torch

import sponge_tpu_torch as st
from sponge_tpu_torch import hash as sthash
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import rescue as rescue_ops
from sponge_tpu_torch.ops.bounds import check_rescue_bounds
from sponge_tpu_torch.ops.rescue import MDS_FIRST_PAIRS, rescue_permute, rescue_permute_plain
from sponge_tpu_torch.poseidon.permutation import overwrite_rows
from spongebench.reference.rescue import Rescue, circulant, hash_elements, merge

FS = st.GOLDILOCKS_FR
P = FS.modulus
CFG = st.get_rpo_parameters(st.GOLDILOCKS_FR)
ROW = (7, 23, 8, 26, 13, 10, 9, 7, 6, 22, 21, 8)  # Rpo256's MDS, first row
REF = Rescue.generate(P, 12, 7, 7, ROW, True)
CAP, RATE, D = 4, 8, 4
CELL = "gl-miden-commit-2p21"


def random_rows(seed, k, lanes):
    """[k][lanes] random field elements; the first lanes take 0, 1, p-1, p-2."""
    rng = random.Random(seed)
    rows = [[rng.randrange(P) for _ in range(lanes)] for _ in range(k)]
    for i, v in enumerate((0, 1, P - 1, P - 2)):
        if i < lanes and k:
            rows[i % k][i] = v
    return rows


def columns(rows):
    return [list(c) for c in zip(*rows)]


def plane(rows):
    return ints_to_mont_tensor(FS, rows, "cpu")


def ints(t):
    return mont_tensor_to_ints(FS, t)


# ---- the parameters ----


def test_parameters_are_midens_shape():
    assert (CFG.t, CFG.rate, CFG.capacity, CFG.alpha, CFG.rounds, CFG.mds_first) == (12, 8, 4, 7, 7, True)
    assert CFG.inv_alpha == 10540996611094048183
    assert CFG.mds[0] == ROW and CFG.mds[1] == ROW[-1:] + ROW[:-1]
    assert CFG.mds == circulant(ROW) == REF.mds
    assert len(CFG.rc) == 14 and all(len(row) == 12 for row in CFG.rc)
    assert CFG.rc == REF.rc  # the reference's own Grain LFSR
    assert CFG.rc == st.generate_rescue_parameters(FS, 8, 4, alpha=7, rounds=7).rc
    with pytest.raises(ValueError, match="Goldilocks"):
        st.get_rpo_parameters(st.BABYBEAR_FR)


def test_default_configs_keep_rescue_primes_order():
    """Every existing config takes the S-box first; the order is part of the
    permutation, so the same constants in the other order give another one."""
    for fs, rate in ((FS, 8), (st.BLS12_381_FR, 2), (st.BABYBEAR_FR, 8)):
        assert not st.get_default_rescue_parameters(fs, rate).mds_first
    flipped = dataclasses.replace(CFG, mds_first=False)
    rows = random_rows(1, 12, 2)
    assert ints(rescue_permute_plain(flipped, st.RescuePermutation(flipped, "cpu").consts, plane(rows))) != \
        ints(rescue_permute_plain(CFG, st.RescuePermutation(CFG, "cpu").consts, plane(rows)))


# ---- the permutation ----


@pytest.mark.parametrize("lanes", [1, 6])
def test_permutation_equals_the_oracle_and_the_reference(lanes):
    rows = random_rows(lanes, 12, lanes)
    got = columns(ints(st.batched_permute(CFG, plane(rows))))
    for col, g in zip(columns(rows), got):
        oracle = st.OracleRescueSponge(CFG)
        oracle.state = list(col)
        oracle.permute()
        assert g == oracle.state == REF.permute(col)


def test_kernel_entry_guards_the_order(monkeypatch):
    """The MDS-first order is compiled at Goldilocks (12, 3) alone, in the
    two-word body (the ``GL_MDS_FIRST`` lines of ``csrc/rescue_words.cu``;
    the limb body of ``csrc/rescue.cu`` has none); there the launch passes
    the order to the kernel; at any other pair an MDS-first config raises
    ``NotImplementedError`` for a CUDA tensor before anything runs."""
    text = (_build.CSRC / "rescue_words.cu").read_text()
    lines = {(int(t), 3) for t in re.findall(r"^\s*GL_MDS_FIRST\((\d+)\)$", text, re.M)}
    assert lines == MDS_FIRST_PAIRS == {(12, 3)} and MDS_FIRST_PAIRS <= rescue_ops.BODIES["two-word"]
    assert not re.search(r"^\s*MDS_FIRST\(", (_build.CSRC / "rescue.cu").read_text(), re.M)
    consts = types.SimpleNamespace(data_ptr=lambda: 0)
    words = st.RescuePermutation(CFG, "cpu").words
    consts.device = words.device
    order = 7  # the round order's place among the C arguments (_build.SIGNATURES)
    assert rescue_ops._launch_args(CFG, consts, words)[order] == 1
    rp = st.get_default_rescue_parameters(FS, 8)
    assert rescue_ops._launch_args(rp, consts, st.RescuePermutation(rp, "cpu").words)[order] == 0
    narrow = dataclasses.replace(st.get_default_rescue_parameters(FS, 4), mds_first=True)  # (8, 3)
    cuda_state = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(narrow.t, FS.nlimbs, 8))

    def refuse(*args):
        raise AssertionError("ran on an uncompiled order")

    monkeypatch.setattr(_build, "check_state", lambda *args: None)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(rescue_ops, "rescue_permute_plain", refuse)
    before = rescue_permute.launches
    with pytest.raises(NotImplementedError, match="MDS-first order"):
        rescue_permute(narrow, torch.zeros(1, dtype=torch.int32), cuda_state)
    assert rescue_permute.launches == before


_Field = namedtuple("_Field", "name modulus r nlimbs")
_Cfg = namedtuple("_Cfg", "field t rounds alpha inv_alpha mds_first")


def test_value_bound_passes_rpo_and_refuses_a_planted_overflow():
    """The replay in RPO's order ends on a chain's product, below 2p; a
    radix of only 2p lets the first MDS row reach R."""
    vmax = check_rescue_bounds(CFG)
    assert 2 * P < vmax < FS.r // 2**6
    p = (1 << 31) - 1
    tight = _Cfg(_Field("tight_rpo", p, 2 * p, 2), 3, 2, 5, pow(5, -1, p - 1), True)
    with pytest.raises(ValueError, match="reach R"):
        check_rescue_bounds(tight)


# ---- Miden's sponge ----


@pytest.mark.parametrize("outputs", [1, 4])
@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 71, 72])
def test_rpo_hash_elements_equals_the_reference(k, outputs):
    lanes = 3
    rows = random_rows(100 + k, k, lanes)
    elems = plane(rows) if k else torch.zeros((0, FS.nlimbs, lanes), dtype=torch.int32)
    got = columns(ints(sthash.rpo_hash_elements(CFG, elems, outputs)))
    want = [hash_elements(REF, col, RATE, CAP, outputs) for col in (columns(rows) if k else [[]] * lanes)]
    assert got == want


def test_rpo_initial_state_tags_the_length():
    for k in (0, 8, 9, 71):
        state = ints(sthash.rpo_initial_state(CFG, k, 2, "cpu"))
        assert [row[0] for row in state] == [k % 8] + [0] * 11


def test_rpo_hash_refuses_what_it_cannot_compute():
    elems = torch.zeros((9, FS.nlimbs, 2), dtype=torch.int32)
    for outputs in (0, 9):
        with pytest.raises(ValueError, match="num_outputs"):
            sthash.rpo_hash_elements(CFG, elems, outputs)
    state = st.zero_state(CFG, 2, "cpu")
    with pytest.raises(ValueError, match="pass the width"):
        overwrite_rows(CFG, state, elems[:8], 5)
    with pytest.raises(ValueError, match="pass the rate"):
        overwrite_rows(CFG, state, elems, 4)


def test_overwrite_rows_after_the_capacity_writes_a_new_plane():
    state = plane(random_rows(5, 12, 2))
    before = state.clone()
    chunk = plane(random_rows(6, 8, 2))
    out = overwrite_rows(CFG, state, chunk, CAP)
    assert torch.equal(state, before)
    assert torch.equal(out[:CAP], state[:CAP]) and torch.equal(out[CAP:], chunk)
    assert torch.equal(overwrite_rows(CFG, state, chunk[:3], CAP)[7:], state[7:])


# ---- Miden's merge tree ----


def test_compress_digest_pairs_is_rpo_merge():
    left, right = random_rows(7, D, 5), random_rows(8, D, 5)
    got = columns(ints(sthash.compress_digest_pairs(CFG, plane(left), plane(right))))
    assert got == [merge(REF, lft, rgt, CAP) for lft, rgt in zip(columns(left), columns(right))]


def test_merkle_tree_openings_and_verification_equal_the_reference():
    """A 2^6-leaf merge tree: every level against the reference's merges,
    openings against the reference's path to the root, and
    ``merkle_verify_batch_wide`` accepting them, a tampered sibling failing
    its own lane only."""
    n, idx = 1 << 6, [0, 5, 33, 63]
    leaves = random_rows(9, D, n)
    levels = sthash.merkle_tree_wide(CFG, plane(leaves))
    want = columns(leaves)
    for level in levels[1:]:
        want = [merge(REF, want[2 * j], want[2 * j + 1], CAP) for j in range(len(want) // 2)]
        assert columns(ints(level)) == want
    root = levels[-1][..., 0]
    paths = sthash.merkle_open_batch_wide(levels, idx)
    for k, index in enumerate(idx):
        cur, i = columns(leaves)[index], index
        for level in paths:
            sib = [FS.mont_plane_to_ints(level[e, :, k : k + 1].numpy())[0] for e in range(D)]
            cur = merge(REF, cur, sib, CAP) if i % 2 == 0 else merge(REF, sib, cur, CAP)
            i >>= 1
        assert cur == columns(ints(root[..., None]))[0]
    opened = plane(columns([columns(leaves)[i] for i in idx]))
    tampered = paths.clone()
    tampered[2, 0, 0, 1] ^= 1
    ok = sthash.merkle_verify_batch_wide(CFG, root, opened, tampered, idx)
    assert ok.tolist() == [True, False, True, True]


# ---- the benchmark's family, job and judge ----


def _family():
    from spongebench.harness import BENCH_DIR, _load_module

    return _load_module(BENCH_DIR / "families" / "rescue.py")


def tiny_cell(**traffic):
    """The cell at 2 rows of 9 elements (two chunks, length tag 1) and one
    row set, so a CPU run takes a few plain permutations."""
    from spongebench import harness

    cell = harness.resolve(CELL)
    cell.traffic = dict(cell.traffic, leaves_log2=1, leaf_elems=9, sets=1, openings=2, **traffic)
    return cell


def tiny_run(cell=None, control=False):
    import time

    from spongebench import harness

    return harness.run(cell or tiny_cell(), 2**40 + 11, 0, False, "cpu", time.perf_counter(), control)


def test_the_cell_runs_rpo_and_reads_correct():
    from spongebench import harness

    cell = harness.resolve(CELL)
    assert cell.chips == 1 and cell.config["family"] == "rescue" and cell.traffic["job"] == "miden"
    assert [name for name, _, _ in cell.per_layer] == ["rescue_bound_share.miden", "leaf_hash_share.miden"]
    assert cell.family.program_config(st, cell.config) is CFG
    out = tiny_run()
    assert out["correct"] is True
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        "answer_mismatches": 0, "leaf_mismatches": 0, "node_mismatches": 0, "proof_failures": 0}


def test_the_control_drops_the_last_round():
    from spongebench import harness

    cell = harness.resolve(CELL)
    control = cell.family.control_config(st, cell.config)
    assert control.rounds == 6 and control.rc == CFG.rc[:12] and control.mds_first
    out = tiny_run(control=True)
    assert out["correct"] is False and out["checks"]["leaf_mismatches"]["value"] > 0


@pytest.mark.parametrize("fault", ["sbox_first", "no_length_tag"])
def test_a_planted_fault_makes_the_cell_not_correct(monkeypatch, fault):
    """The S-box-first order (Rescue-Prime's, with RPO's constants) in the
    program's config, or Miden's length tag dropped from the leaf sponge:
    the judge reads ``correct`` false."""
    cell = tiny_cell()
    if fault == "sbox_first":
        make = cell.family.program_config
        monkeypatch.setattr(cell.family, "program_config",
                            lambda s, c: dataclasses.replace(make(s, c), mds_first=False))
    else:
        monkeypatch.setattr(sthash, "rpo_initial_state",
                            lambda cfg, k, batch, device: st.zero_state(cfg, batch, device))
    out = tiny_run(cell)
    assert out["correct"] is False and out["checks"]["leaf_mismatches"]["value"] > 0


def test_the_family_refuses_another_configuration():
    from spongebench import harness

    config = harness.resolve(CELL).config
    family = _family()
    for key, value in (("rounds", 8), ("mds_first", False), ("alpha", 5), ("mds", list(ROW[::-1]))):
        with pytest.raises(ValueError):
            family.program_config(st, dict(config, **{key: value}))


def test_the_job_refuses_another_mode_and_a_program_without_the_leaf_hash(monkeypatch):
    """A configuration stating another absorb fails; so does a program
    without ``rpo_hash_elements``, before any input is made."""
    from spongebench import harness
    from spongebench.jobs import commit

    cell = harness.resolve(CELL)
    with pytest.raises(ValueError, match="Miden job"):
        cell.job.Job(CFG, dict(cell.config, absorb="overwrite"), cell.traffic, "cpu", 1)

    def refuse(*args, **kwargs):
        raise AssertionError("made an input")

    monkeypatch.setattr(commit, "random_plane", refuse)
    monkeypatch.delattr(sthash, "rpo_hash_elements")
    with pytest.raises(AttributeError):
        cell.job.Job(CFG, cell.config, cell.traffic, "cpu", 1)


def test_permutations_and_their_bound():
    """9 permutations a row of 71 and one a node; the least work of one
    permutation at two words an element: 7 rounds of 12 S-boxes x^7 (14)
    and x^(1/7) (255) and two MDS layers of 12 rows of 24, 26,628 wide
    multiply-adds, 3.18 ns at the H100's peak, which the states' bytes at
    the HBM rate do not pass."""
    from spongebench import harness
    from spongebench.roofline import PEAKS

    cell = harness.resolve(CELL)
    family = cell.family
    assert family.permutation_products(cell.config) == 26_628 == 7 * (12 * (14 + 255) + 2 * 12 * 24)
    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    assert family.permutations_bound_s(peaks, cell.config, 10**9) == pytest.approx(26_628 / peaks.wide_per_s * 1e9)
    assert 3.1 < family.permutations_bound_s(peaks, cell.config, 10**9) < 3.3
    n = 1 << 21
    job = types.SimpleNamespace(cfg=CFG, n=n, k=71, d=4, hash_leaves=True)
    assert cell.job.Job.permutations.fget(job) == 9 * n + n - 1
    with pytest.raises(ValueError, match="Goldilocks"):
        family.permutation_products(dict(cell.config, modulus=(1 << 31) - 1))


def test_rescue_bound_share_reads_the_permutation_kernels():
    from spongebench import harness
    from spongebench.harness import TraceContext
    from spongebench.roofline import PEAKS
    from spongebench.trace import Trace

    cell = harness.resolve(CELL)
    read = {name: reader for name, _, reader in cell.per_layer}["rescue_bound_share.miden"]
    events = [{"ph": "X", "cat": "kernel", "name": "void sponge::rescue_kernel<12, 3, true>(int const*)",
               "ts": 0, "dur": 400_000},
              {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4>()",
               "ts": 400_000, "dur": 5_000}]
    ctx = TraceContext(Trace.from_events(events), 4, 1000, cell.config, cell.family, "NVIDIA H100 80GB HBM3")
    bound = cell.family.permutations_bound_s(PEAKS[ctx.device], cell.config, 4000)
    assert read(ctx) == pytest.approx(100 * bound / 0.4)
    ctx.device = "cpu"
    assert read(ctx) is None


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_kernel_and_leaf_hash_equal_their_plain_versions_on_the_card(cuda):
    """Kernel 5's MDS-first order (its two-word body, with the module's
    word buffer) at 1,000 lanes (not a multiple of a block) and a
    71-element leaf hash through it, against the plain versions on the same
    card."""
    perm = st.RescuePermutation(CFG, cuda)
    consts = perm.consts
    state = plane(random_rows(20, 12, 1000)).to(cuda)
    before = rescue_permute.launches
    out = rescue_permute(CFG, consts, state, perm.words)
    assert rescue_permute.launches == before + 1
    assert torch.equal(out, rescue_permute_plain(CFG, consts, state))
    leaves = plane(random_rows(21, 71, 1000)).to(cuda)
    assert torch.equal(sthash.rpo_hash_elements(CFG, leaves, D), sthash.rpo_hash_elements(CFG, leaves, D, "plain"))
