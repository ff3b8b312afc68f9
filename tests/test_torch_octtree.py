"""Filecoin's sealing tree on the port: the domain-tagged arity-k node hash
(``hash.compress_children``, a fresh state whose capacity starts from
neptune's tag 2^k - 1), the arity-k tree, its openings and verification
(``hash.merkle_tree_arity`` and the rest), the tag in kernel 1's step
(``absorb_permute``'s ``tag``, folded into the first round's constants
by ``PoseidonPermutation.tagged``), the
``merkle.tagged`` span, and the benchmark's ``bls381-fil-tree-r-2p27`` cell
and its judge, against the benchmark's plain reference
(``spongebench/reference/octtree.py``) and the JAX package's oracle, at
8^2 and 8^3 BLS12-381 leaves of t = 9 on seeded random inputs on the CPU.
The card test holds kernel 1's tagged step to its plain version on the
card and skips without one; the JAX package is imported inside the one
test that reads it, so the card runs this file without JAX."""

import random
import time
import types

import pytest
import torch

import sponge_tpu_torch as st
from sponge_tpu_torch import hash as sthash
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import poseidon_opt as opt
from sponge_tpu_torch.ops.bounds import check_kernel_bounds, simulate
from sponge_tpu_torch.poseidon.permutation import absorb_permute, tag_plane, zero_state
from sponge_tpu_torch.utils import profiling
from spongebench.reference import octtree
from spongebench.reference.poseidon import Poseidon

FS = st.BLS12_381_FR
P = FS.modulus
CFG = st.get_default_poseidon_parameters(FS, 8)  # neptune's arity-8 shape: t = 9, alpha 5, 8 + 57
REF = Poseidon.generate(P, 8, 1, 5, 8, 57)
ARITY, TAG = 8, 255
CELL = "bls381-fil-tree-r-2p27"


def random_leaves(seed, n):
    """n random field elements; the first eight p - 1 (a node whose
    children are all p - 1), the next 0, 1, p - 2."""
    rng = random.Random(seed)
    out = [rng.randrange(P) for _ in range(n)]
    out[:8] = [P - 1] * 8
    out[8:11] = [0, 1, P - 2]
    return out


def plane(rows):
    return ints_to_mont_tensor(FS, rows, "cpu")


def ints(t):
    return mont_tensor_to_ints(FS, t)


def children_view(leaves):
    """(8, L, n/8): each lane's eight children where they lie (lane stride 8)."""
    flat = plane([leaves])[0]
    return flat.reshape(FS.nlimbs, -1, ARITY).permute(2, 0, 1)


# ---- the node hash ----


def test_the_configuration_is_neptunes_arity_8_shape():
    assert (CFG.t, CFG.rate, CFG.capacity, CFG.alpha, CFG.full_rounds, CFG.partial_rounds) == (9, 8, 1, 5, 8, 57)
    assert tuple(map(tuple, CFG.ark)) == REF.ark and tuple(map(tuple, CFG.mds)) == REF.mds
    assert sthash.neptune_merkle_tag(8) == octtree.merkle_tag(8) == TAG
    assert sthash.neptune_merkle_tag(2) == 3
    with pytest.raises(ValueError, match="arity"):
        sthash.neptune_merkle_tag(1)


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_compress_children_equals_the_reference_and_the_jax_oracle(backend):
    """Tag 255 in the capacity, eight strided children in the rate: element
    1 of the permuted state, by the reference's tagged hash and by the JAX
    package's oracle permutation of [255, c_0, ..., c_7]; "auto" is kernel
    1's step in its plain version, "plain" the zero state tagged and
    ``add_rows``."""
    import sponge_tpu
    from sponge_tpu.poseidon.oracle import OraclePoseidonSponge as JaxOracle

    leaves = random_leaves(3, 6 * ARITY)
    got = ints(sthash.compress_children(CFG, children_view(leaves), TAG, backend))
    jcfg = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, 8)
    for j, g in enumerate(got):
        kids = leaves[j * ARITY : (j + 1) * ARITY]
        oracle = JaxOracle(jcfg)
        oracle.state = [TAG] + kids
        oracle.permute()
        assert g == octtree.tagged_hash(REF, TAG, kids) == oracle.state[1]


def test_a_tag_is_the_capacity_of_a_fresh_sponge_under_every_family():
    """A family without kernel 1's step (Poseidon2 at Goldilocks, capacity
    4) starts the zero state's capacity from the tag: the oracle's
    permutation of [tag, 0, 0, 0, rows]; a zero tag is no tag."""
    cfg = st.get_default_poseidon2_parameters(st.GOLDILOCKS_FR, 8)
    fs = cfg.field
    rng = random.Random(5)
    rows = [[rng.randrange(fs.modulus) for _ in range(3)] for _ in range(8)]
    tag = (7, 0, 0, fs.modulus - 1)
    got = mont_tensor_to_ints(fs, absorb_permute(cfg, None, 0, ints_to_mont_tensor(fs, rows, "cpu"), tag=tag))
    for b in range(3):
        oracle = cfg.oracle_sponge()
        oracle.state = list(tag) + [row[b] for row in rows]
        oracle.permute()
        assert [row[b] for row in got] == oracle.state
    zero = absorb_permute(cfg, None, 0, ints_to_mont_tensor(fs, rows, "cpu"), tag=(0, 0, 0, 0))
    assert torch.equal(zero, absorb_permute(cfg, None, 0, ints_to_mont_tensor(fs, rows, "cpu")))


def test_no_tag_leaves_absorb_permute_as_it_was():
    """Without a tag the step is the zero sponge's, by value on both paths,
    and a zero tag computes the same; a tag on a state it does not start,
    or one that is not canonical or has another length, is refused."""
    kids = children_view(random_leaves(4, 4 * ARITY))
    untagged = absorb_permute(CFG, None, 0, kids, out_rows=(1, 2))
    state = zero_state(CFG, kids.shape[-1], "cpu")
    assert torch.equal(untagged, absorb_permute(CFG, state, 0, kids, out_rows=(1, 2)))
    assert torch.equal(untagged, absorb_permute(CFG, None, 0, kids, out_rows=(1, 2), backend="plain"))
    assert torch.equal(untagged, absorb_permute(CFG, None, 0, kids, out_rows=(1, 2), tag=(0,)))
    assert not torch.equal(untagged, absorb_permute(CFG, None, 0, kids, out_rows=(1, 2), tag=(TAG,)))
    with pytest.raises(ValueError, match="fresh sponge"):
        absorb_permute(CFG, state, 0, kids, tag=(TAG,))
    with pytest.raises(ValueError, match="canonical"):
        tag_plane(CFG, (P,), "cpu")
    with pytest.raises(ValueError, match="capacity rows"):
        tag_plane(CFG, (TAG, 0), "cpu")
    assert tag_plane(CFG, (TAG,), "cpu") is tag_plane(CFG, [TAG], "cpu")  # built once
    assert ints(tag_plane(CFG, (TAG,), "cpu")[..., None]) == [[TAG]]


def test_the_tagged_step_is_the_same_launch_on_folded_constants(monkeypatch):
    """Kernel 1's tagged step launches as the untagged one does, with the
    constants of ``PoseidonPermutation.tagged`` (built once per tag): they
    differ from the module's in ARK row 0's capacity element alone, by the
    tag, and every other argument of the launch is the same."""
    from sponge_tpu_torch.poseidon.config import unpack_constants

    calls = []
    monkeypatch.setattr(_build, "launch", lambda symbol, state, out, *args, shape: calls.append(args))
    monkeypatch.setattr(opt.permute_opt, "launches", 0)
    perm = st.PoseidonPermutation(CFG, "cpu")
    tagged = perm.tagged((TAG,))
    assert perm.tagged((TAG,)) is tagged and tagged.cfg.ark[1:] == CFG.ark[1:]
    assert tagged.cfg.ark[0] == ((CFG.ark[0][0] + TAG) % P, *CFG.ark[0][1:])
    mine, theirs = unpack_constants(CFG, perm.consts), unpack_constants(CFG, tagged.consts)
    assert mine.keys() == theirs.keys() and not torch.equal(mine["ark"][0, 0], theirs["ark"][0, 0])
    diff = mine["ark"] != theirs["ark"]
    assert diff[0, 0].any() and not diff[0, 1:].any() and not diff[1:].any()
    assert all(torch.equal(mine[k], theirs[k]) for k in mine if k != "ark")
    kids = children_view(random_leaves(6, 2 * ARITY))
    for m in (perm, tagged):
        out = opt._launch(m.cfg, m.consts, m.opt_words, None, 1, (kids,), (1, 2), kids.shape[-1])
        assert out.shape == (1, FS.nlimbs, 2)
    (plain_args, tagged_args) = calls
    ptr = 3  # the constants' place among the C arguments (_build.SIGNATURES)
    assert (plain_args[ptr], tagged_args[ptr]) == (perm.consts.data_ptr(), tagged.consts.data_ptr())
    assert plain_args[:ptr] == tagged_args[:ptr] and plain_args[ptr + 1 :] == tagged_args[ptr + 1 :]
    assert plain_args[-13:] == (kids.data_ptr(), None, 8, 1, kids.shape[-1] * 8, 8, 0, 0, 0, 1, 1, 1, 2)
    assert opt.permute_opt.launches == 2


def test_the_tagged_steps_bounds_replay_passes():
    """The replay bounds values, not constants: it starts from canonical
    elements in every row and canonical round constants, which the folded
    first-round constant is (reduced mod p), so the tagged config's replay
    is the untagged one's; at (9, 11) it ends below 2p with every value
    below R."""
    tagged = st.PoseidonPermutation(CFG, "cpu").tagged((P - 1,)).cfg
    assert all(0 <= c < P for c in tagged.ark[0])
    vmax = check_kernel_bounds(tagged, optimized=True)
    v, out = simulate(tagged, True)
    assert v == vmax == check_kernel_bounds(CFG, optimized=True) < FS.r and out <= 2 * P
    assert ints(tag_plane(CFG, (P - 1,), "cpu")[..., None]) == [[P - 1]]


# ---- the tree ----


@pytest.mark.parametrize("log8", [2, 3])
def test_merkle_tree_arity_equals_the_reference(log8):
    n = ARITY**log8
    leaves = random_leaves(10 + log8, n)
    levels = sthash.merkle_tree_arity(CFG, plane([leaves])[0], ARITY, TAG)
    want = octtree.tree(REF, leaves, ARITY, TAG)
    assert [lv.shape[-1] for lv in levels] == [ARITY**i for i in range(log8, -1, -1)]
    assert [ints(lv) for lv in levels] == want
    assert ints(sthash.merkle_root_arity(CFG, plane([leaves])[0], ARITY, TAG)[:, None]) == [octtree.root(
        REF, leaves, ARITY, TAG)]


def test_merkle_tree_arity_refuses_a_count_that_is_not_a_power_of_the_arity():
    for n in (16, 72):
        with pytest.raises(ValueError, match="power of the arity"):
            sthash.merkle_tree_arity(CFG, torch.zeros((FS.nlimbs, n), dtype=torch.int32), ARITY, TAG)
    with pytest.raises(ValueError, match="children"):
        sthash.compress_children(CFG, torch.zeros((9, FS.nlimbs, 2), dtype=torch.int32), TAG)


def test_open_then_verify_accepts_and_rejects_a_flipped_sibling():
    """Paths of seven siblings a level, against the reference's path to the
    root; ``merkle_verify_batch_arity`` accepts them and fails only the
    lane whose sibling was flipped."""
    n, idx = ARITY**2, [0, 9, 63, 17]
    leaves = random_leaves(21, n)
    levels = sthash.merkle_tree_arity(CFG, plane([leaves])[0], ARITY, TAG)
    want = octtree.tree(REF, leaves, ARITY, TAG)
    paths = sthash.merkle_open_batch_arity(levels, idx, ARITY)
    assert paths.shape == (2, ARITY - 1, FS.nlimbs, len(idx))
    for k, index in enumerate(idx):
        a = index
        for d, level in enumerate(want[:-1]):
            group = level[a - a % ARITY : a - a % ARITY + ARITY]
            assert ints(paths[d, :, :, k : k + 1].transpose(0, 1).reshape(FS.nlimbs, -1)) == \
                group[: a % ARITY] + group[a % ARITY + 1 :]
            a //= ARITY
    root, opened = levels[-1][:, 0], plane([[leaves[i] for i in idx]])[0]
    assert sthash.merkle_verify_batch_arity(CFG, root, opened, paths, idx, ARITY, TAG).tolist() == [True] * 4
    flipped = paths.clone()
    flipped[1, 3, 0, 2] ^= 1
    assert sthash.merkle_verify_batch_arity(CFG, root, opened, flipped, idx, ARITY, TAG).tolist() == \
        [True, True, False, True]
    assert not sthash.merkle_verify_batch_arity(CFG, root, opened, paths, idx, ARITY, None).any()
    with pytest.raises(IndexError):
        sthash.merkle_verify_batch_arity(CFG, root, opened, paths, [n], ARITY, TAG)


@pytest.mark.parametrize("backend,fused", [("auto", 100.0), ("plain", 0.0)])
def test_each_tagged_compression_is_a_span_counting_its_nodes(tmp_path, backend, fused):
    """``merkle.tree`` holds a ``merkle.level`` a level, each holding one
    ``merkle.tagged`` counting the nodes, with kernel 1's step inside
    (``sponge.absorb_fused``, or ``sponge.absorb`` on the plain path);
    ``tagged_fused_share.fil`` reads 100 and 0."""
    from spongebench import harness

    leaves = plane([random_leaves(30, ARITY**2)])[0]
    with profiling.trace(tmp_path):
        sthash.merkle_tree_arity(CFG, leaves, ARITY, TAG, backend)
    spans = profiling.spans()
    names = [s["name"] for s in spans]
    tagged = [i for i, name in enumerate(names) if name == "merkle.tagged"]
    assert [spans[i]["count"] for i in tagged] == [8, 1]
    assert all(names[spans[i]["parent"]] == "merkle.level" for i in tagged)
    inner = "sponge.absorb_fused" if backend == "auto" else "sponge.absorb"
    assert [s["count"] for s in spans if s["name"] == inner and s["parent"] in tagged] == [8, 1]
    read = {name: reader for name, _, reader in harness.resolve(CELL).per_layer}["tagged_fused_share.fil"]
    assert read(None) == fused


# ---- the benchmark's cell, job and judge ----


def tiny_cell(**traffic):
    """The cell at 8^2 leaves and one leaf set, so a CPU run takes a few
    plain steps."""
    from spongebench import harness

    cell = harness.resolve(CELL)
    cell.traffic = dict(cell.traffic, leaves_log2=6, sets=1, **traffic)
    return cell


def tiny_run(cell=None, control=False):
    from spongebench import harness

    return harness.run(cell or tiny_cell(), 2**40 + 23, 0, False, "cpu", time.perf_counter(), control)


def test_the_cell_resolves_by_name_and_reads_correct():
    from spongebench import harness

    cell = harness.resolve(CELL)
    assert cell.chips == 1 and cell.config["family"] == "poseidon" and cell.traffic["job"] == "octtree"
    assert (cell.config["arity"], cell.config["domain_tag"], cell.traffic["leaves_log2"]) == (8, 255, 27)
    assert [name for name, _, _ in cell.per_layer] == ["octtree_bound_share.fil", "tagged_fused_share.fil"]
    assert [name for name, _, _ in cell.end_to_end] == ["leaves_per_s", "commit_ms_p90", "setup_s"]
    assert cell.family.program_config(st, cell.config) is CFG
    out = tiny_run()
    assert out["correct"] is True
    assert {k: c["value"] for k, c in out["checks"].items()} == {"answer_mismatches": 0, "node_mismatches": 0}


@pytest.mark.parametrize("fault", ["control", "no_tag", "altered_root"])
def test_the_control_and_a_planted_fault_read_not_correct(monkeypatch, fault):
    """The family's control (its last partial round dropped), the tag left
    out of every node, or the root altered where it is produced: the judge
    reads ``correct`` false."""
    real_compress, real_tree = sthash.compress_children, sthash.merkle_tree_arity
    if fault == "no_tag":
        monkeypatch.setattr(sthash, "compress_children",
                            lambda cfg, children, tag=None, backend="auto": real_compress(cfg, children, None, backend))
    if fault == "altered_root":
        def altered(*args):
            levels = real_tree(*args)
            root = levels[-1].clone()
            root[0, 0] ^= 1
            return levels[:-1] + [root]

        monkeypatch.setattr(sthash, "merkle_tree_arity", altered)
    out = tiny_run(control=fault == "control")
    assert out["correct"] is False
    if fault == "altered_root":
        assert out["checks"]["node_mismatches"]["value"] > 0
    else:
        assert out["checks"]["node_mismatches"]["value"] >= 9  # every node of both levels sampled


def test_the_job_refuses_what_it_cannot_build(monkeypatch):
    """A configuration without ``arity`` and ``domain_tag``, openings, a
    leaf count that is not a power of the arity; and a program without
    ``merkle_tree_arity``, before any input is made."""
    from spongebench.jobs import octtree as job_mod

    cell = tiny_cell()
    for config, traffic in (({k: v for k, v in cell.config.items() if k != "arity"}, cell.traffic),
                            (cell.config, dict(cell.traffic, openings=3)),
                            (cell.config, dict(cell.traffic, leaves_log2=7))):
        with pytest.raises(ValueError):
            cell.job.Job(CFG, config, traffic, "cpu", 1)

    def refuse(*args, **kwargs):
        raise AssertionError("made an input")

    monkeypatch.setattr(job_mod, "random_plane", refuse)
    monkeypatch.setattr(cell.job, "random_plane", refuse)
    monkeypatch.delattr(sthash, "merkle_tree_arity")
    with pytest.raises(AttributeError):
        cell.job.Job(CFG, cell.config, cell.traffic, "cpu", 1)


def test_permutations_and_the_bound_share():
    """(n - 1) / 7 permutations a tree, 19,173,961 at 2^27 leaves; the
    bound at t = 9, alpha 5, 8 + 57 rounds is 353,650 widening products a
    permutation, 42.3 ns at the H100's peak; ``octtree_bound_share.fil``
    is that bound over the permutation kernels' time, None off the card."""
    from spongebench import harness
    from spongebench.harness import TraceContext
    from spongebench.roofline import PEAKS, permutation_products
    from spongebench.trace import Trace

    cell = harness.resolve(CELL)
    job = types.SimpleNamespace(n=1 << 27, arity=8)
    assert cell.job.Job.permutations.fget(job) == 19_173_961 == (2**27 - 1) // 7
    assert permutation_products(P, 9, 5, 8, 57) == (353_650, 0)
    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    assert 42.2e-9 < cell.family.permutations_bound_s(peaks, cell.config, 1) < 42.4e-9
    read = {name: reader for name, _, reader in cell.per_layer}["octtree_bound_share.fil"]
    events = [{"ph": "X", "cat": "kernel", "name": "void sponge::poseidon_opt_kernel<9, 11>(int const*)",
               "ts": 0, "dur": 1_200_000},
              {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4>()",
               "ts": 1_200_000, "dur": 5_000}]
    ctx = TraceContext(Trace.from_events(events), 1, 19_173_961, cell.config, cell.family,
                       "NVIDIA H100 80GB HBM3")
    bound = cell.family.permutations_bound_s(peaks, cell.config, 19_173_961)
    assert read(ctx) == pytest.approx(100 * bound / 1.2)
    assert 67 < read(ctx) < 68
    ctx.device = "cpu"
    assert read(ctx) is None


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_tagged_step_and_tree_equal_their_plain_versions_on_the_card(cuda):
    """Kernel 1's tagged step at (9, 11) over 8^5 leaves (each level's
    children read with lane stride 8, the narrow levels below a block)
    against the plain backend on the same card, one launch a level."""
    leaves = plane([random_leaves(40, ARITY**5)])[0].to(cuda)
    before = opt.permute_opt.launches
    levels = sthash.merkle_tree_arity(CFG, leaves, ARITY, TAG)
    assert opt.permute_opt.launches == before + 5
    plain = sthash.merkle_tree_arity(CFG, leaves, ARITY, TAG, "plain")
    assert all(torch.equal(a, b) for a, b in zip(levels, plain))
