"""``poseidon.permutation.absorb_permute``, one sponge step: rate rows added
into a state (or a fresh zero sponge), the permutation, the rows kept.

On kernel 1's path (a Poseidon config with R_P >= 2, backend "auto") it is
one launch of kernel 1 that adds the rows as it loads the state and stores
only the rows kept (``csrc/poseidon_opt.cu`` ``RateIO``), or that launch's
plain version on the CPU; every other config and backend takes ``add_rows``,
``batched_permute`` and a slice.  Both are held, bit for bit, to
``add_rows`` + ``batched_permute`` + slice.  The tests marked ``card`` hold
the kernel to its plain version on the card at every (t, L) pair kernel 1
is built for, and skip without a CUDA device:

    python -m pytest --noconftest -m card tests/test_torch_absorb_permute.py

This file imports nothing of JAX, so it runs on a machine without it.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sponge_tpu_torch as st
from sponge_tpu_torch.family import permutation_for
from sponge_tpu_torch.fields import ints_to_limbs, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.poseidon_opt import absorb_permute_opt, absorb_permute_opt_plain, permute_opt
from sponge_tpu_torch.poseidon import permutation as perm_mod
from sponge_tpu_torch.poseidon.permutation import absorb_permute, add_rows, batched_permute, zero_state
from sponge_tpu_torch.utils import profiling as prof

LANES = 20  # on the CPU; lanes 0..15 pair the edge values of state and rows


def values(fs, rows, lanes, seed, edge_of):
    """A (rows, L, lanes) plane of canonical stored values: lane b < 16 holds
    the edge value ``edge_of(b)`` of 0, 1, p - 1, p - 2, the rest random."""
    rng = np.random.default_rng(seed)
    edges = (0, 1, fs.modulus - 1, fs.modulus - 2)
    grid = [[edges[edge_of(b)] if b < 16 else int.from_bytes(rng.bytes(40), "little") % fs.modulus
             for b in range(lanes)] for _ in range(rows)]
    return torch.from_numpy(np.stack([ints_to_limbs(fs, row) for row in grid]))


def state_plane(cfg, lanes, seed):
    return values(cfg.field, cfg.t, lanes, seed, lambda b: b // 4 % 4)


def row_views(cfg, k, n_views, lanes, seed, device="cpu"):
    """``n_views`` (k, L, lanes) views on ``device``: one contiguous plane,
    or the even and odd lanes of one plane of twice the lanes (lane stride
    2), as a Merkle level hands its children over."""
    rows = values(cfg.field, k, n_views * lanes, seed, lambda b: b % 4).to(device)
    if n_views == 1:
        return (rows,)
    pairs = rows.reshape(k, cfg.field.nlimbs, lanes, 2)
    return pairs[..., 0], pairs[..., 1]


def reference(cfg, state, start, views, out_rows, backend="auto"):
    """The unfused step: ``add_rows`` of the views' ``cat``, the
    permutation, the rows kept."""
    lanes = views[0].shape[-1]
    state = zero_state(cfg, lanes, views[0].device) if state is None else state
    out = batched_permute(cfg, add_rows(cfg, state, start, torch.cat(views)), backend)
    return out if out_rows is None else out[out_rows[0] : out_rows[1]]


def tiny_config():
    """A 35-bit test field config at (3, 2): alpha 17, R_F 8, R_P 8, its
    constants drawn from seed 11."""
    fs = st.FieldSpec(name="tiny_fr_35", modulus=(1 << 35) - 31, generator=3)
    rng = np.random.default_rng(11)
    draw = lambda: int(rng.integers(0, 1 << 62)) % fs.modulus
    ark = tuple(tuple(draw() for _ in range(3)) for _ in range(16))
    mds = tuple(tuple(draw() for _ in range(3)) for _ in range(3))
    return st.PoseidonConfig(field=fs, full_rounds=8, partial_rounds=8, alpha=17, ark=ark, mds=mds, rate=2)


CONFIGS = {
    "bls381-r2": lambda: st.get_default_poseidon_parameters(st.BLS12_381_FR, 2),
    "goldilocks-t12": lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8),
    "babybear-t16": lambda: st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8),
}


def step_cases():
    """(config, fresh, start, views, kept) over every combination a config's
    rate holds: start 0 or 1, one view or two (each of k rows, k as large as
    the rate allows), all rows kept or the first rate rows after the
    capacity."""
    out = []
    for name in CONFIGS:
        rate = CONFIGS[name]().rate
        for fresh in (True, False):
            for start in (0, 1):
                for n_views in (1, 2):
                    if (rate - start) // n_views == 0:
                        continue
                    for kept in ("all", "squeeze"):
                        out.append(pytest.param(name, fresh, start, n_views, kept,
                                                id=f"{name}-{'fresh' if fresh else 'state'}-start{start}-"
                                                   f"{n_views}view-{kept}"))
    return out


def kept_rows(cfg, kept):
    return None if kept == "all" else (cfg.capacity, cfg.capacity + min(4, cfg.rate))


@pytest.mark.parametrize("name,fresh,start,n_views,kept", step_cases())
def test_step_equals_add_rows_permute_slice(name, fresh, start, n_views, kept):
    cfg = CONFIGS[name]()
    k = (cfg.rate - start) // n_views
    state = None if fresh else state_plane(cfg, LANES, 1)
    views = row_views(cfg, k, n_views, LANES, 2)
    out_rows = kept_rows(cfg, kept)
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = absorb_permute(cfg, state, start, *views, out_rows=out_rows)
    want = reference(cfg, state, start, views, out_rows)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, want)
    spans = [(s["name"], s["parent"], s["count"]) for s in prof.spans()]
    assert spans == [(prof.ABSORB_FUSED, None, LANES), (prof.PERMUTE, 0, LANES)]


def test_step_with_no_rows_permutes_a_fresh_sponge():
    cfg = CONFIGS["goldilocks-t12"]()
    empty = torch.zeros((0, cfg.field.nlimbs, LANES), dtype=torch.int32)
    got = absorb_permute(cfg, None, 0, empty, out_rows=(cfg.capacity, cfg.capacity + 2))
    want = batched_permute(cfg, zero_state(cfg, LANES, "cpu"))[cfg.capacity : cfg.capacity + 2]
    assert torch.equal(got, want)


def r_p_one_config():
    """A BLS12-381 rate-2 config with one partial round: kernel 2's path."""
    base = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    return st.PoseidonConfig(field=base.field, full_rounds=8, partial_rounds=1, alpha=base.alpha,
                             ark=base.ark[:9], mds=base.mds, rate=2)


FALLBACKS = {
    "poseidon2": (lambda: st.get_default_poseidon2_parameters(st.GOLDILOCKS_FR, 4), "auto"),
    "plain": (lambda: st.get_default_poseidon_parameters(st.BLS12_381_FR, 2), "plain"),
    "partial-rounds-1": (r_p_one_config, "auto"),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
@pytest.mark.parametrize("n_views", (1, 2))
def test_other_paths_take_add_rows_and_batched_permute(name, n_views, monkeypatch):
    """A Poseidon2 config, the "plain" backend and a Poseidon config kernel 1
    does not run (R_P < 2) never reach kernel 1's step: a ``sponge.absorb``
    span, then a ``sponge.permute`` span, and the unfused step's rows."""
    make, backend = FALLBACKS[name]
    cfg = make()

    def refuse(*args):
        raise AssertionError("took kernel 1's step")

    monkeypatch.setattr(perm_mod, "absorb_permute_opt", refuse)
    state = values(cfg.field, cfg.t, LANES, 3, lambda b: b // 4 % 4)
    views = row_views(cfg, cfg.rate // 2, n_views, LANES, 4)
    out_rows = (cfg.capacity, cfg.capacity + 1)
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = absorb_permute(cfg, state, 0, *views, out_rows=out_rows, backend=backend)
    assert [(s["name"], s["parent"]) for s in prof.spans()] == [(prof.ABSORB, None), (prof.PERMUTE, None)]
    assert torch.equal(got, reference(cfg, state, 0, views, out_rows, backend))


@pytest.mark.parametrize("name", ("bls381-r2", "partial-rounds-1"))
def test_kernel_backends_on_the_cpu_take_the_unfused_step_and_raise(name, monkeypatch):
    """"kernel" names a CUDA kernel: on the CPU neither kernel 1's step (a
    config with R_P >= 2) nor the unfused step's permutation (R_P < 2, kernel
    2) launches; both refuse the tensor as ``batched_permute`` does."""
    cfg = CONFIGS[name]() if name in CONFIGS else r_p_one_config()
    monkeypatch.setattr(perm_mod, "absorb_permute_opt", lambda *args: pytest.fail("took kernel 1's step"))
    rows = row_views(cfg, 1, 1, LANES, 5)[0]
    with pytest.raises(ValueError, match="runs a CUDA kernel"):
        absorb_permute(cfg, None, 0, rows, backend="kernel")


FAMILIES = {
    "poseidon": (st.PoseidonPermutation, lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 4)),
    "poseidon2": (st.Poseidon2Permutation, lambda: st.get_default_poseidon2_parameters(st.GOLDILOCKS_FR, 4)),
    "rescue": (st.RescuePermutation, lambda: st.get_default_rescue_parameters(st.GOLDILOCKS_FR, 4)),
    "gmimc": (st.GmimcPermutation, lambda: st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)),
    "griffin": (st.GriffinPermutation, lambda: st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4)),
    "anemoi": (st.AnemoiPermutation, lambda: st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4)),
    "monolith": (st.MonolithPermutation, lambda: st.get_default_monolith_parameters(st.GOLDILOCKS_FR, 4)),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_one_dispatch_for_every_family(name):
    """``family.permutation_for`` finds each family's module from its
    config's type (Poseidon's alone with a one-launch step),
    ``batched_permute`` equals the family's oracle, and ``absorb_permute``
    under "auto" equals "plain"."""
    module, make = FAMILIES[name]
    cfg = make()
    cpu = torch.device("cpu")
    perm = permutation_for(cfg, cpu)
    assert type(perm) is module and perm is permutation_for(cfg, cpu) and perm.fused == (name == "poseidon")
    state = state_plane(cfg, 8, 12)
    want = []
    for lane in zip(*mont_tensor_to_ints(cfg.field, state)):
        o = cfg.oracle_sponge()
        o.state = list(lane)
        o.permute()
        want.append(o.state)
    assert mont_tensor_to_ints(cfg.field, batched_permute(cfg, state)) == [list(r) for r in zip(*want)]
    rows = row_views(cfg, cfg.rate, 1, 8, 13)[0]
    got = absorb_permute(cfg, state, 0, rows, out_rows=(cfg.capacity, cfg.t))
    assert torch.equal(got, absorb_permute(cfg, state, 0, rows, out_rows=(cfg.capacity, cfg.t), backend="plain"))


def test_step_refuses_rows_past_the_rate_and_bad_planes():
    cfg = CONFIGS["goldilocks-t12"]()
    consts = st.PoseidonPermutation(cfg, "cpu").consts
    rows = row_views(cfg, 5, 1, LANES, 6)[0]
    with pytest.raises(ValueError, match="pass the rate"):
        absorb_permute(cfg, None, 0, rows, rows)
    with pytest.raises(ValueError, match="pass the rate"):
        absorb_permute(cfg, None, 4, rows)
    with pytest.raises(ValueError, match="output rows"):
        absorb_permute_opt(cfg, consts, None, cfg.capacity, (rows,), (5, 5))
    with pytest.raises(TypeError):
        absorb_permute_opt(cfg, consts, None, cfg.capacity, (rows.long(),), (0, cfg.t))
    with pytest.raises(ValueError, match="one shape"):
        absorb_permute_opt(cfg, consts, None, cfg.capacity, (rows, rows[:2]), (0, cfg.t))
    with pytest.raises(ValueError, match="state"):
        absorb_permute_opt(cfg, consts, state_plane(cfg, LANES + 1, 7), cfg.capacity, (rows,), (0, cfg.t))
    with pytest.raises(ValueError, match="no kernel for device"):
        absorb_permute_opt(cfg, consts.to("meta"), None, cfg.capacity, (rows.to("meta"),), (0, cfg.t))


# ---- on the card ----


def pair_configs():
    """One config at each (t, L) pair kernel 1 is built for
    (``_build.POSEIDON_PAIRS``)."""
    cfgs = [st.get_default_poseidon_parameters(st.BLS12_381_FR, rate) for rate in range(2, 9)]
    cfgs += [st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, rate) for rate in (4, 8)]
    cfgs += [st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8), tiny_config()]
    assert {(c.t, c.field.nlimbs) for c in cfgs} == _build.POSEIDON_PAIRS
    return cfgs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


CARD_LANES = 1000  # not a multiple of the kernel's 128 threads a block


@pytest.mark.card
@pytest.mark.parametrize("index", range(len(_build.POSEIDON_PAIRS)))
def test_kernel_step_equals_its_plain_version_on_the_card(index, cuda):
    """Kernel 1's step at each (t, L): fresh and given states, one view and
    two of lane stride 2, start 0 and inside the rate, all rows and the
    squeezed rows, against ``absorb_permute_opt_plain`` on the same card;
    the launches are counted on ``permute_opt``."""
    cfg = pair_configs()[index]
    perm = st.PoseidonPermutation(cfg, cuda)
    consts, words = perm.consts, perm.opt_words
    cases = [(True, 0, 2, "squeeze"), (False, 0, 2, "all"), (True, 0, 1, "all"), (False, 1, 1, "squeeze")]
    for fresh, start, n_views, kept in cases:
        k = max(1, (cfg.rate - start) // n_views)
        state = None if fresh else state_plane(cfg, CARD_LANES, 8).to(cuda)
        views = row_views(cfg, k, n_views, CARD_LANES, 9, cuda)
        assert n_views == 1 or views[0].stride()[-1] == 2
        out_rows = kept_rows(cfg, kept) or (0, cfg.t)
        before = permute_opt.launches
        got = absorb_permute_opt(cfg, consts, state, cfg.capacity + start, views, out_rows, words)
        assert permute_opt.launches == before + 1
        want = absorb_permute_opt_plain(cfg, consts, state, cfg.capacity + start, views, out_rows)
        torch.cuda.synchronize()
        label = f"t={cfg.t} L={cfg.field.nlimbs} fresh={fresh} start={start} views={n_views} {kept}"
        assert got.shape == (out_rows[1] - out_rows[0], cfg.field.nlimbs, CARD_LANES), label
        assert torch.equal(got, want), label
