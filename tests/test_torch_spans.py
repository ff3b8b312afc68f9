"""The port's spans (``utils/profiling.py`` ``annotate``, ``spans``,
``reset``): while a profiler records, every tree, level, opening, hash,
absorb and permutation dispatch of the port is one span, nested as the
calls nest, with its count; the ``sponge.permute`` counts add up to the
permutations a shape needs; while none records, ``annotate`` is one shared
no-op and nothing is kept.  The benchmark's five readers of the spans
(``spongebench/metrics``) on hand-built span lists.  On the CPU no span has
a device time."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import sponge_tpu_torch as st
from sponge_tpu_torch import hash as sthash
from sponge_tpu_torch.fields import ints_to_mont_tensor
from sponge_tpu_torch.transcript import Absorb, SqueezeNative, compile_transcript
from sponge_tpu_torch.utils import profiling as prof

GL = st.GOLDILOCKS_FR
B = 4  # lanes
LEAVES = 4

# Each family's default Goldilocks config, and the tree it commits with:
# (kind, digest elements).
FAMILIES = {
    "poseidon": (lambda: st.get_default_poseidon_parameters(GL, 4), ("narrow", 1)),
    "poseidon2": (lambda: st.get_default_poseidon2_parameters(GL, 4), ("wide", 2)),
    "rescue": (lambda: st.get_default_rescue_parameters(GL, 4), ("wide", 2)),
    "gmimc": (lambda: st.get_default_gmimc_parameters(GL, 4), ("wide", 2)),
    "griffin": (lambda: st.get_default_griffin_parameters(GL, 4), ("wide", 2)),
    "anemoi": (lambda: st.get_default_anemoi_parameters(GL, 4), ("jive", 4)),
    "monolith": (lambda: st.get_default_monolith_parameters(GL), ("wide", 4)),
}
PATHS = ("tree", "hash_elements", "transcript")


def ceil_div(a, b):
    return -(-a // b)


def fused(cfg):
    """Whether the config's sponge steps are one launch of kernel 1 (or its
    plain version): a Poseidon config."""
    return isinstance(cfg, st.PoseidonConfig)


def expected_hash(k, outputs, rate, lanes, parent, out, fused=False):
    """The spans of ``hash_elements`` over k elements, appended to ``out``
    as (name, parent, count): the absorbs, the permutations between them,
    the flip to squeezing, one more per further rate of outputs.  Fused, each
    rate's absorb holds its permutation, the last one the flip."""
    me = len(out)
    out.append((prof.ELEMENTS, parent, lanes))
    chunks = ceil_div(k, rate)
    for i in range(chunks):
        if fused:
            out.append((prof.ABSORB_FUSED, me, lanes))
            out.append((prof.PERMUTE, len(out) - 1, lanes))
            continue
        out.append((prof.ABSORB, me, lanes))
        if i < chunks - 1:
            out.append((prof.PERMUTE, me, lanes))
    if not fused:
        out.append((prof.PERMUTE, me, lanes))
    out.extend([(prof.PERMUTE, me, lanes)] * (ceil_div(outputs, rate) - 1))


def expected_tree(cfg, kind, d, n, out, parent=None):
    me = len(out)
    out.append((prof.TREE, parent, n))
    while n > 1:
        n //= 2
        level = len(out)
        out.append((prof.LEVEL, me, n))
        if kind == "jive":
            out.append((prof.PERMUTE, level, n))
        else:
            expected_hash(2 * d, d, cfg.rate, n, level, out, fused(cfg))


def shape(spans):
    return [(s["name"], s["parent"], s["count"]) for s in spans]


def run_path(cfg, path, kind, d):
    """Run one path of the port on zero planes; the spans it is expected to
    open."""
    want = []
    L = cfg.field.nlimbs
    if path == "tree":
        leaves = torch.zeros((d, L, LEAVES), dtype=torch.int32)
        if kind == "narrow":
            sthash.merkle_tree(cfg, leaves[0])
        elif kind == "jive":
            sthash.merkle_tree_jive(cfg, leaves)
        else:
            sthash.merkle_tree_wide(cfg, leaves)
        expected_tree(cfg, kind, d, LEAVES, want)
    elif path == "hash_elements":
        k = cfg.rate + 1
        sthash.hash_elements(cfg, torch.zeros((k, L, B), dtype=torch.int32), 2)
        expected_hash(k, 2, cfg.rate, B, None, want, fused(cfg))
    else:
        run = compile_transcript(cfg, [Absorb(cfg.rate + 1), SqueezeNative(2)])
        run(torch.zeros((cfg.rate + 1, L, B), dtype=torch.int32))
        # Absorb r + 1: r rows, the full rate's permutation, one row; the
        # squeeze's flip; the two outputs fit the rate.
        want = [(prof.ABSORB, None, B), (prof.PERMUTE, None, B), (prof.ABSORB, None, B),
                (prof.PERMUTE, None, B)]
    return want


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_span_tree_of_each_family(family, path):
    make, (kind, d) = FAMILIES[family]
    cfg = make()
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        want = run_path(cfg, path, kind, d)
    got = prof.spans()
    assert shape(got) == want
    for s in got:
        assert s["device_us"] is None  # no CUDA on the CPU
        assert s["host_us"] is not None and s["host_us"] >= 0
        if s["parent"] is not None:
            assert got[s["parent"]]["host_us"] >= s["host_us"]


def commitment(cfg, n, k, d, openings):
    """A commitment as the benchmark's commit job makes it: leaves hashed
    when k > d, the tree, openings."""
    L = cfg.field.nlimbs
    leaves = torch.zeros((k, L, n), dtype=torch.int32)
    digests = sthash.hash_elements(cfg, leaves, d) if k > d else leaves
    if d == 1:
        levels = [lv[None] for lv in sthash.merkle_tree(cfg, digests[0])]
    else:
        levels = sthash.merkle_tree_wide(cfg, digests)
    if openings:
        sthash.merkle_open_batch(levels, list(range(openings)))


# The benchmark's two cells at 2^log2n leaves: (field, rate, leaf elements,
# digest elements, openings).
CELLS = {
    "bls381-merkle": (st.BLS12_381_FR, 2, 1, 1, 0),
    "gl-fri-commit": (GL, 8, 135, 4, 3),
}


def cell_permutations(rate, k, d, n):
    """The permutations of one commitment, as the commit job reckons them."""
    per_leaf = ceil_div(k, rate) + ceil_div(d, rate) - 1 if k > d else 0
    return n * per_leaf + n - 1


def cell_spans(rate, k, d, log2n, openings):
    """Spans of one commitment: the leaf hash (one, its absorbs and
    permutations), the tree (one, four a level), the openings (one)."""
    per_hash = 1 + ceil_div(k, rate) + ceil_div(k, rate) + ceil_div(d, rate) - 1 if k > d else 0
    return per_hash + 1 + 4 * log2n + (1 if openings else 0)


def test_cell_counts_at_full_size():
    assert cell_permutations(2, 1, 1, 1 << 24) == 16_777_215
    assert cell_permutations(8, 135, 4, 1 << 21) == 37_748_735 == 18 * 2**21 - 1
    assert cell_spans(2, 1, 1, 24, 0) == 97
    assert cell_spans(8, 135, 4, 21, 28) == 121


@pytest.mark.parametrize("cell", list(CELLS))
def test_permute_counts_add_up_to_the_cells_permutations(cell):
    field, rate, k, d, openings = CELLS[cell]
    cfg = st.get_default_poseidon_parameters(field, rate)
    log2n = 3 if k == 1 else 2
    n = 1 << log2n
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        commitment(cfg, n, k, d, openings)
    got = prof.spans()
    assert sum(s["count"] for s in got if s["name"] == prof.PERMUTE) == cell_permutations(rate, k, d, n)
    assert len(got) == cell_spans(rate, k, d, log2n, openings)
    outer = [s["name"] for s in got if s["parent"] is None]
    assert outer == ([prof.ELEMENTS] if k > d else []) + [prof.TREE] + ([prof.OPEN] if openings else [])
    if openings:
        assert got[-1]["count"] == openings


@pytest.mark.parametrize("cell", list(CELLS))
def test_cells_absorb_inside_the_permutation_launch(cell):
    """Every absorb of both cells' commitments is a sponge step of kernel 1
    (its plain version here): a ``sponge.absorb_fused`` span around one
    ``sponge.permute`` span of the same lanes, and no ``sponge.absorb``
    span; the permutations' lanes are the job's count, as before."""
    field, rate, k, d, openings = CELLS[cell]
    cfg = st.get_default_poseidon_parameters(field, rate)
    log2n = 3 if k == 1 else 2
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        commitment(cfg, 1 << log2n, k, d, openings)
    got = prof.spans()
    absorbs = [i for i, s in enumerate(got) if s["name"] == prof.ABSORB_FUSED]
    permutes = [s for s in got if s["name"] == prof.PERMUTE]
    assert not [s for s in got if s["name"] == prof.ABSORB]
    assert [s["parent"] for s in permutes] == absorbs
    assert [got[i]["count"] for i in absorbs] == [s["count"] for s in permutes]
    assert sum(s["count"] for s in permutes) == cell_permutations(rate, k, d, 1 << log2n)


def test_annotate_is_one_shared_noop_with_the_profiler_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert prof.annotate(prof.PERMUTE, 4) is prof.annotate("other")
    prof.reset()
    cfg = st.get_default_monolith_parameters(GL)
    sthash.merkle_tree_wide(cfg, torch.zeros((4, cfg.field.nlimbs, 4), dtype=torch.int32))
    assert prof.spans() == []


def test_warmup_step_records_no_span():
    """The harness profiles with ``schedule(wait=0, warmup=1, active=...)``:
    PyTorch's fast-check flag (``torch.autograd.profiler._is_profiler_enabled``,
    private) is off in the warm-up step and on in the active ones, so the
    spans cover the active steps alone.  A torch that renames the flag fails
    here rather than leaving every span silent."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    cfg = st.get_default_monolith_parameters(GL)
    state = st.zero_state(cfg, B, "cpu")
    prof.reset()
    seen = []
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=2)) as p:
        for _ in range(3):
            st.batched_permute(cfg, state)
            seen.append((torch.autograd.profiler._is_profiler_enabled, len(prof.spans())))
            p.step()
    assert seen == [(False, 0), (True, 1), (True, 2)]


def test_spans_are_user_annotations_in_the_chrome_trace(tmp_path):
    cfg = st.get_default_monolith_parameters(GL)
    with prof.trace(tmp_path):
        sthash.hash_elements(cfg, torch.zeros((9, cfg.field.nlimbs, B), dtype=torch.int32), 4)
    events = json.loads((tmp_path / prof.TRACE_FILE).read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count(prof.ELEMENTS) == 1
    assert names.count(prof.ABSORB) == 2 and names.count(prof.PERMUTE) == 2
    assert [s["name"] for s in prof.spans()] == [prof.ELEMENTS, prof.ABSORB, prof.PERMUTE, prof.ABSORB,
                                                 prof.PERMUTE]


def test_trace_starts_from_no_spans(tmp_path):
    cfg = st.get_default_monolith_parameters(GL)
    state = st.zero_state(cfg, B, "cpu")
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        st.batched_permute(cfg, state)
    assert len(prof.spans()) == 1
    with prof.trace(tmp_path):
        st.batched_permute(cfg, state)
        st.batched_permute(cfg, state)
    assert shape(prof.spans()) == [(prof.PERMUTE, None, B)] * 2
    prof.reset()
    assert prof.spans() == []


def test_spans_leave_the_outputs_unchanged():
    cfg = st.get_default_monolith_parameters(GL)
    values = [[(7 * i + 3 * j) * 0x9E3779B97F4A7C15 % GL.modulus for j in range(8)] for i in range(4)]
    leaves = ints_to_mont_tensor(GL, values, "cpu")
    plain = sthash.merkle_tree_wide(cfg, leaves)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = sthash.merkle_tree_wide(cfg, leaves)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_a_span_closes_when_its_block_raises():
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with prof.annotate(prof.TREE, 8):
                raise ValueError("inside")
        with prof.annotate(prof.OPEN, 2):
            pass
    got = prof.spans()
    assert shape(got) == [(prof.TREE, None, 8), (prof.OPEN, None, 2)]
    assert got[0]["host_us"] is not None


def test_threads_nest_their_own_spans():
    """Spans opened in several threads at once each find their parent in
    their own thread, and none is lost."""
    threads, depth, rounds = 8, 3, 50
    prof.reset()

    def work(tag):
        for _ in range(rounds):
            with prof.annotate(f"outer{tag}", tag):
                for _ in range(depth):
                    with prof.annotate(f"inner{tag}", tag):
                        pass

    with profile(activities=[ProfilerActivity.CPU]):
        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    got = prof.spans()
    assert len(got) == threads * rounds * (1 + depth)
    for s in got:
        if s["name"].startswith("inner"):
            parent = got[s["parent"]]
            assert parent["name"] == "outer" + s["name"][5:] and parent["count"] == s["count"]
        else:
            assert s["parent"] is None


# ---- the benchmark's readers of the spans ----

H100 = "NVIDIA H100 80GB HBM3"
READERS = ("absorb_share.commit", "tail_levels_share.commit", "dispatch_host_us.commit",
           "permute_bound_share.commit")


def span(name, parent, count, host_us, device_us):
    return {"name": name, "parent": parent, "count": count, "host_us": host_us, "device_us": device_us}


# A hashed leaf set of 2^18 lanes, then a tree over them: one wide level
# (2^17 nodes, not narrow) and one narrow (2^16), then an opening.
HAND_MADE = [
    span(prof.ELEMENTS, None, 1 << 18, 90.0, 400.0),
    span(prof.ABSORB, 0, 1 << 18, 20.0, 60.0),
    span(prof.PERMUTE, 0, 1 << 18, 30.0, 300.0),
    span(prof.TREE, None, 1 << 18, 200.0, 500.0),
    span(prof.LEVEL, 3, 1 << 17, 70.0, 350.0),
    span(prof.ELEMENTS, 4, 1 << 17, 60.0, 340.0),
    span(prof.ABSORB, 5, 1 << 17, 10.0, 40.0),
    span(prof.PERMUTE, 5, 1 << 17, 40.0, 280.0),
    span(prof.LEVEL, 3, 1 << 16, 80.0, 100.0),
    span(prof.ELEMENTS, 8, 1 << 16, 70.0, 90.0),
    span(prof.ABSORB, 9, 1 << 16, 5.0, 20.0),
    span(prof.PERMUTE, 9, 1 << 16, 5000.0, 60.0),  # a launch that waited for the queue
    span(prof.PERMUTE, 9, 0, 900.0, 0.0),  # no lanes: not a dispatch
    span(prof.OPEN, None, 28, 10.0, 100.0),
]


@pytest.fixture
def readers():
    from spongebench.harness import TraceContext, resolve

    cell = resolve("gl-fri-commit-2p21")
    ctx = TraceContext(None, 4, 0, cell.config, cell.family, H100)
    return ctx, {name: reader for name, _, reader in cell.per_layer if name in READERS}


def test_readers_on_a_hand_made_span_list(readers, monkeypatch):
    from spongebench.roofline import PEAKS

    ctx, read = readers
    assert sorted(read) == sorted(READERS)
    monkeypatch.setattr(prof, "spans", lambda: [dict(s) for s in HAND_MADE])
    assert read["absorb_share.commit"](ctx) == pytest.approx(100 * 120 / 1000)
    assert read["tail_levels_share.commit"](ctx) == pytest.approx(100 * 100 / 500)
    assert read["dispatch_host_us.commit"](ctx) == 40.0  # the median: the wait does not move it
    bound = ctx.family.permutations_bound_s(PEAKS[H100], ctx.config, (1 << 18) + (1 << 17) + (1 << 16))
    assert read["permute_bound_share.commit"](ctx) == pytest.approx(100 * bound / 640e-6)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ("no_spans_api", "no_spans", "no_device_time"))
def test_readers_give_none_without_what_they_read(readers, monkeypatch, name, case):
    ctx, read = readers
    if case == "no_spans_api":  # a program before the spans
        monkeypatch.delattr(prof, "spans")
    elif case == "no_spans":
        monkeypatch.setattr(prof, "spans", lambda: [])
    else:  # a run on the host
        monkeypatch.setattr(prof, "spans", lambda: [dict(s, device_us=None) for s in HAND_MADE])
    assert read[name](ctx) is None


def test_absorb_fused_share_counts_lanes(monkeypatch):
    """``absorb_fused_share.commit``: the fused absorbs' lanes over all
    absorbed lanes, with or without device times; None with no absorb."""
    from spongebench.harness import resolve

    cell = resolve("gl-fri-commit-2p21")
    read = {name: reader for name, _, reader in cell.per_layer}["absorb_fused_share.commit"]
    fused = [span(prof.ABSORB_FUSED, None, 1 << 18, 40.0, 300.0), span(prof.PERMUTE, 0, 1 << 18, 30.0, 290.0),
             span(prof.ABSORB_FUSED, None, 1 << 16, 40.0, None)]
    for spans, want in ((HAND_MADE, 0.0), (fused, 100.0), (HAND_MADE + fused, 100 * 5 / 12),
                        ([], None), (HAND_MADE[3:5], None)):
        monkeypatch.setattr(prof, "spans", lambda spans=spans: [dict(s) for s in spans])
        assert read(None) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(prof, "spans")
    assert read(None) is None


def test_permute_bound_share_needs_the_cards_peaks(readers, monkeypatch):
    ctx, read = readers
    monkeypatch.setattr(prof, "spans", lambda: [dict(s) for s in HAND_MADE])
    ctx.device = "cpu"
    assert read["permute_bound_share.commit"](ctx) is None
    assert read["absorb_share.commit"](ctx) is not None
