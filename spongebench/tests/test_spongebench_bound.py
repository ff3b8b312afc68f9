"""The copied metric arithmetic: the bound of kernel 1 at the program's
recorded pairs, and the trace reduction on a hand-made trace."""

from types import SimpleNamespace

import pytest

from spongebench.data import random_plane
from spongebench.harness import TraceContext
from spongebench.reference import planes
from spongebench.roofline import PEAKS, permutation_products, poseidon_bound_s
from spongebench.trace import Trace, is_permutation, short_name

H100 = PEAKS["NVIDIA H100 80GB HBM3"]
P_BLS = 52435875175126190479447740508185965837690552500527637822603658699938581184513
P_GL = (1 << 64) - (1 << 32) + 1


@pytest.mark.parametrize("p, t, alpha, rp, ms", [
    (P_BLS, 3, 17, 31, 12.106),  # kernel 1 at (3, 11)
    (P_GL, 12, 7, 22, 1.099),  # kernel 1 at (12, 3)
])
def test_bound_of_kernel_1_at_2p20(p, t, alpha, rp, ms):
    assert round(poseidon_bound_s(H100, p, t, alpha, 8, rp, 1 << 20) * 1e3, 3) == ms


def test_bound_counts_one_word_below_2p31():
    wide, narrow = permutation_products((15 << 27) + 1, 16, 7, 8, 13)
    assert wide > 0 and narrow > 0


def test_random_plane_is_canonical():
    for p in (P_BLS, P_GL):
        plane = random_plane(p, (3, planes.nlimbs(p), 64), 2**40 + 1, "cpu")
        for row in plane:
            assert None not in planes.decode(p, row.numpy())
        again = random_plane(p, (3, planes.nlimbs(p), 64), 2**40 + 1, "cpu")
        assert (plane == again).all()


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def hand_made():
    """One step of 100 us: the program's permutation kernel 10-50,
    PyTorch's add 45-60 (overlapping it by 5), a copy 70-80, a kernel of
    the program's own that is not a permutation (a fused absorb) 82-90; the
    host in aten::cat 60-70 and aten::copy_ 80-100."""
    return Trace.from_events([
        _event("ProfilerStep#1", "user_annotation", 0, 100),
        _event("void sponge::poseidon_opt_kernel<3, 11>(int const*)", "kernel", 10, 40),
        _event("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int> >()", "kernel", 45, 15),
        _event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 70, 10),
        _event("void sponge::fused_absorb_kernel<12, 3>(int const*, int*)", "kernel", 82, 8),
        _event("aten::cat", "cpu_op", 60, 10),
        _event("aten::copy_", "cpu_op", 80, 20),
    ])


def test_busy_union_and_gaps():
    tr = hand_made()
    assert tr.window == (0, 100)
    assert tr.busy_us() == 68  # 10-60, 70-80 and 82-90
    assert tr.busy_us(tr.permutation_kernels()) == 40
    assert tr.busy_us(tr.glue()) == 33  # the add, the copy and the fused absorb
    assert len(tr.kernels()) == 3
    assert tr.gaps() == [(0, 10), (60, 70), (80, 82), (90, 100)]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["sponge::poseidon_opt_kernel<3, 11>", pytest.approx(40e-6)]
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"(no host event)": 10e-6, "aten::cat": 10e-6, "aten::copy_": 12e-6})


@pytest.mark.parametrize("name, perm", [
    ("void sponge::poseidon_opt_kernel<3, 11>(int const*, int*, long long)", True),
    ("sponge::poseidon_dense_gl_kernel<12>", True),
    ("void sponge::poseidon2_word_kernel<16, 2>(int const*)", True),
    ("void sponge::fused_absorb_kernel<12, 3>(int const*, int*)", False),
    ("void sponge::chains_kernel<4>(int const*)", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int> >()", False),
    ("Memcpy DtoH (Device -> Pageable)", False),
])
def test_permutation_kernels_by_entry_point_name(name, perm):
    assert is_permutation(name) is perm


def test_short_name_drops_only_the_argument_list():
    assert short_name("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 2>(int*, long)") == \
        "at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 2>"
    assert short_name("void at::native::k<2, f(long)::{lambda(long)#1}>(char*)") == \
        "at::native::k<2, f(long)::{lambda(long)#1}>"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert short_name("sponge::poseidon_opt_kernel<3, 11>") == "sponge::poseidon_opt_kernel<3, 11>"


def test_metric_readers_on_the_hand_made_trace():
    from spongebench.harness import resolve

    cell = resolve("bls381-merkle-2p24")
    ctx = TraceContext(hand_made(), 1, 4, cell.config, cell.family, "NVIDIA H100 80GB HBM3")
    got = {name: reader(ctx) for name, _, reader in cell.per_layer}
    assert got["glue_share.commit"] == pytest.approx(100 * 33 / 68)
    assert got["launches.commit"] == 3
    assert got["device_idle_share.commit"] == pytest.approx(32.0)
    bound = poseidon_bound_s(H100, P_BLS, 3, 17, 8, 31, 4)
    assert got["perm_bound_share.commit"] == pytest.approx(100 * bound / 40e-6)
    ctx.device = "cpu"  # no peaks: the share is left out, never 0
    readers = {name: reader for name, _, reader in cell.per_layer}
    assert readers["perm_bound_share.commit"](ctx) is None


def test_end_to_end_readers_on_a_hand_made_window():
    from spongebench.harness import Window, resolve

    cell = resolve("bls381-merkle-2p24")
    jobs = [SimpleNamespace(units=1 << 24, ms=float(ms)) for ms in range(300, 320)]
    ctx = Window(jobs, 6.2, 7.5)
    got = {name: reader(ctx) for name, _, reader in cell.end_to_end}
    assert got == pytest.approx({"leaves_per_s": 20 * (1 << 24) / 6.2, "commit_ms_p90": 317.1,
                                 "setup_s": 7.5})
