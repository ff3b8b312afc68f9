"""Kernel 1's two-word body (``csrc/poseidon_opt_words.cu``): the
sparse-factorized Poseidon permutation at Goldilocks on one 64-bit word in
plain form per element, with kernel 1's rate I/O.

``Kernel1GL`` emulates the body word by word for one lane: the entry (the
state's stored value, or zero, plus the absorbed rows by ``gl_add``, then
the product by 2^-72 mod p), the full rounds (``gl_add``, the S-boxes, the
MDS rows summed in five words and reduced once by ``gl_reduce5``), each
sparse round (c^ by ``gl_add``, the row0 dot as one row, x_i + col0_i x0 as
one product added to x_i in the accumulator and reduced once), D, and the
exit (the product by 2^72 mod p, one conditional subtraction).  It is held,
bit for bit, to ``absorb_permute_opt_plain`` and to the scalar oracle at
both Goldilocks widths kernel 1 runs, (8, 3) and (12, 3), the latter
``gl-poseidon-t12``'s plonky2 shape, for the plain permutation, a fresh
state with one view, a Merkle level's two views of lane stride 2 and a kept
subset of rows; every accumulator stays within its replay
(``ops/bounds.py`` ``check_opt_gl_bounds``).  Then the replay's refusals,
the body choice over every default config, the launch arguments (no
fallback, no launch without the word buffer) and the word buffer against
the limb buffer.  The CUDA kernel itself runs on the card
(``chip_smoke.py``; ``tests/test_torch_absorb_permute.py``'s card tests).
"""

import dataclasses
import types

import pytest
import torch
from test_torch_absorb_permute import row_views, state_plane, tiny_config
from test_torch_dense import _M32, _M64, Kernel2GL
from test_torch_permutation import default_poseidon_configs

import sponge_tpu_torch as st
from sponge_tpu_torch.fields import limbs_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import poseidon_opt as opt
from sponge_tpu_torch.ops.bounds import _OptGLSim, check_opt_gl_bounds
from sponge_tpu_torch.poseidon.config import unpack_constants
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge

LANES = 20  # lanes 0..15 pair the edge values 0, 1, p-1, p-2 of state and rows


class Kernel1GL(Kernel2GL):
    """``poseidon_opt_kernel<T>`` of ``csrc/poseidon_opt_words.cu`` for one
    lane, on the stored (Montgomery form) values of the plane.  Products,
    squarings and ``gl_add`` as ``Kernel2GL``'s; ``tmax`` is the largest top
    word n4 of an accumulator."""

    def __init__(self, cfg):
        self.cfg, self.tmax = cfg, 0
        w = [int(v) & _M32 for v in opt.word_constants(cfg)]
        values = iter([w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)])

        def take(rows, n):
            return [[next(values) for _ in range(n)] for _ in range(rows)]

        t, k = cfg.t, cfg.partial_rounds - 1
        (self.to_word, self.from_word), = take(1, 2)
        self.ark, self.mds = take(cfg.rounds, t), take(t, t)
        self.chat, self.row0, self.col0, self.dense = take(k, t), take(k, t), take(k, t - 1), take(t, t)
        assert next(values, None) is None

    def row(self, x, m):
        """``gl_row``: the t products summed exactly, one ``gl_reduce5``."""
        assert all(v <= _M64 for v in x)
        return self.reduce5(sum(a * b for a, b in zip(x, m)))

    def mac(self, x, a, c):
        """x + a c: x in the accumulator's low words, the product added by
        ``gl_mac``, one ``gl_reduce5``."""
        assert x <= _M64 and a <= _M64
        return self.reduce5(x + a * c)

    def full_round(self, x, ark):
        x = [self.pow(self.add(v, c), self.cfg.alpha) for v, c in zip(x, ark)]
        return [self.row(x, m) for m in self.mds]

    def permute_words(self, x):
        cfg, alpha = self.cfg, self.cfg.alpha
        half, P = cfg.full_rounds // 2, cfg.partial_rounds
        for r in range(half):
            x = self.full_round(x, self.ark[r])
        x = [self.add(v, c) for v, c in zip(x, self.ark[half])]
        for r in range(P):
            x[0] = self.pow(x[0], alpha)
            if r == P - 1:
                break
            x = [self.add(v, c) for v, c in zip(x, self.chat[r])]
            x = [self.row(x, self.row0[r])] + [self.mac(v, x[0], c) for v, c in zip(x[1:], self.col0[r])]
        x = [self.row(x, m) for m in self.dense]
        for r in range(half + P, cfg.rounds):
            x = self.full_round(x, self.ark[r])
        return x

    def step(self, stored, rows, lo, kept):
        """One lane of a launch: ``stored`` the t stored values (None: a
        fresh state), ``rows`` the absorbed rows' stored values in order
        (row j into state row lo + j), ``kept`` = (a, b); the stored values
        of rows a..b-1."""
        p = self.cfg.field.modulus
        x = []
        for e in range(self.cfg.t):
            v = 0 if stored is None else stored[e]
            if lo <= e < lo + len(rows):
                v = self.add(v, rows[e - lo])
            x.append(self.mul(v, self.to_word))
        out = []
        for v in self.permute_words(x)[kept[0] : kept[1]]:
            v = self.mul(v, self.from_word)
            v = v - p if v >= p else v
            assert v < p
            out.append(v)
        return out


def stored(fs, plane):
    """(k, L, B) plane -> [k][B] stored values."""
    return [limbs_to_ints(fs, row.numpy()) for row in plane]


CONFIGS = {
    "goldilocks-t8": lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 4),
    "goldilocks-t12-plonky2": lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8),
}


def case_args(cfg, case):
    """(state or None, views, state row of the first view, kept rows) of
    each case."""
    d = cfg.rate // 2  # a Merkle node's digest elements: two children fill the rate
    if case == "plain":
        return state_plane(cfg, LANES, 1), (torch.zeros((0, 3, LANES), dtype=torch.int32),), cfg.capacity, (0, cfg.t)
    if case == "fresh-one-view":
        return None, row_views(cfg, cfg.rate, 1, LANES, 2), cfg.capacity, (0, cfg.t)
    if case == "merkle-level":
        views = row_views(cfg, d, 2, LANES, 3)
        assert views[0].stride()[-1] == 2
        return None, views, cfg.capacity, (cfg.capacity, cfg.capacity + d)
    assert case == "kept-rows"
    return state_plane(cfg, LANES, 4), row_views(cfg, 3, 1, LANES, 5), cfg.capacity + 1, (2, 7)


@pytest.mark.parametrize("case", ["plain", "fresh-one-view", "merkle-level", "kept-rows"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulation_equals_plain_step_and_oracle(name, case):
    """Each lane's words through the emulated body equal kernel 1's plain
    step (``absorb_permute_opt_plain``, the CPU path of every caller) and
    the oracle's permutation of the state plus the rows, on lanes of 0, 1,
    p-1, p-2 in state and rows and on random lanes; every accumulator's top
    word within the replay's."""
    cfg = CONFIGS[name]()
    fs, p = cfg.field, cfg.field.modulus
    assert opt.body(cfg) == "two-word" and (cfg.t, fs.nlimbs) in opt.BODIES["two-word"]
    consts = st.PoseidonPermutation(cfg, "cpu").consts
    state, views, lo, kept = case_args(cfg, case)
    want = opt.absorb_permute_opt_plain(cfg, consts, state, lo, views, kept)
    rows = [r for v in views for r in stored(fs, v)]
    base = None if state is None else stored(fs, state)
    kernel = Kernel1GL(cfg)
    got = [kernel.step(None if base is None else [row[b] for row in base], [row[b] for row in rows], lo, kept)
           for b in range(LANES)]
    assert [list(col) for col in zip(*got)] == stored(fs, want)
    for b in range(LANES):
        o = OraclePoseidonSponge(cfg)
        o.state = [0 if base is None else fs.from_mont(base[e][b]) for e in range(cfg.t)]
        for j, row in enumerate(rows):
            o.state[lo + j] = (o.state[lo + j] + fs.from_mont(row[b])) % p
        o.permute()
        assert [fs.from_mont(v) for v in got[b]] == o.state[kept[0] : kept[1]], b
    assert kernel.tmax <= check_opt_gl_bounds(cfg) == cfg.t - 1


def test_replay_passes_every_default_goldilocks_config():
    """The four default Goldilocks Poseidon configs (rates 4 and 8, both
    tables) pass; the largest top word is that of a full row, t - 1."""
    gl = [cfg for cfg in default_poseidon_configs().values() if cfg.field == st.GOLDILOCKS_FR]
    assert len(gl) == 4
    for cfg in gl:
        assert check_opt_gl_bounds(cfg) == cfg.t - 1


def _planted(t):
    """A Goldilocks Poseidon shape at width ``t`` for the replay alone (it
    reads no constants)."""
    return types.SimpleNamespace(field=st.GOLDILOCKS_FR, t=t, full_rounds=2, partial_rounds=2, alpha=7)


class _NoSparseReduce(_OptGLSim):
    """The replay with x_i + col0_i x0 left in its accumulator: the next
    round's product input is no word."""

    def mac(self, x, y):
        return (x[0] - 1) + (y[0] - 1) * (self.p - 1) + 1, 1


REFUSALS = {
    "rows-reach-2^160": (lambda: _OptGLSim(_planted((1 << 32) + 2)).run(), "a row sum can reach 2\\^160"),
    "fix-up-wraps": (lambda: _OptGLSim(_planted((1 << 32) - 1)).run(),
                     "fix-up of a negative sum can wrap"),
    "not-goldilocks": (lambda: check_opt_gl_bounds(st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8)),
                       "2\\^64 - 2\\^32"),
    "no-sparse-reduce": (lambda: _NoSparseReduce(st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8)).run(),
                         "can reach 2\\^128"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_replay_refuses_planted_configs(name):
    """The replay refuses a width whose row sums can reach 2^160, one whose
    row reduction's fix-up can wrap, a field other than Goldilocks, and a
    schedule whose sparse accumulator is not reduced."""
    check, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        check()


def test_body_choice_for_every_default_config():
    """All 52 default configs: the two-word body at Goldilocks (8, 3) and
    (12, 3), the limb body elsewhere, (16, 2) and L = 11 among them, and the
    35-bit test field's (3, 2); each body's pair is compiled and the pairs
    make up ``_build.INSTANTIATIONS``; only the two-word body has a word
    buffer."""
    assert frozenset().union(*opt.BODIES.values()) == _build.INSTANTIATIONS["sponge_poseidon_opt"]
    assert not opt.BODIES["limb"] & opt.BODIES["two-word"]
    configs = default_poseidon_configs()
    for label, cfg in configs.items():
        kind = opt.body(cfg)
        assert kind == ("two-word" if cfg.field == st.GOLDILOCKS_FR else "limb"), label
        assert (cfg.t, cfg.field.nlimbs) in opt.BODIES[kind], label
        words = 2 * (2 + cfg.rounds * cfg.t + 2 * cfg.t ** 2 + (cfg.partial_rounds - 1) * (3 * cfg.t - 1))
        assert len(opt.word_constants(cfg)) == (words if kind == "two-word" else 0), label
    counts = {k: sum(opt.body(c) == k for c in configs.values()) for k in opt.BODIES}
    assert counts == {"limb": 48, "two-word": 4}
    assert opt.body(tiny_config()) == "limb" and (3, 2) in opt.BODIES["limb"]


def test_launch_args_by_body():
    """The limb body's arguments end in body 0 and no word buffer; the
    two-word body's in body 2, the module's ``opt_words`` buffer (not
    kernel 2's) and its length, and it refuses a missing, short, long or
    misplaced buffer.  A 60-bit field at (12, 3), the two-word body's pair,
    takes the limb body, which lacks the pair: NotImplementedError, no
    fallback."""
    cfg = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8)
    perm = st.PoseidonPermutation(cfg, "cpu")
    consts, words = perm.consts, perm.opt_words
    head = (cfg.alpha, cfg.full_rounds, cfg.partial_rounds, consts.data_ptr(), cfg.field.n0inv)
    assert opt._launch_args(cfg, consts, words) == head + (2, words.data_ptr(), len(opt.word_constants(cfg)))
    assert torch.equal(words, torch.from_numpy(opt.word_constants(cfg))) and words.numel() != perm.words.numel()
    for bad in (None, words[1:], torch.cat([words, words[:2]]), perm.words, words.to("meta")):
        with pytest.raises(ValueError, match="word_constants"):
            opt._launch_args(cfg, consts, bad)
    fs60 = st.FieldSpec(name="f60", modulus=(1 << 60) - 93, generator=2)
    other = dataclasses.replace(cfg, field=fs60, ark=tuple(tuple(v % fs60.modulus for v in r) for r in cfg.ark),
                                mds=tuple(tuple(v % fs60.modulus for v in r) for r in cfg.mds))
    assert (other.t, other.field.nlimbs) == (12, 3) and opt.body(other) == "limb"
    with pytest.raises(NotImplementedError, match="kernel 1's limb body"):
        opt._launch_args(other, st.PoseidonPermutation(other, "cpu").consts, None)


@pytest.mark.parametrize("rate", [4, 8])
def test_word_constants_are_the_limb_buffer_in_plain_form(rate):
    """Past its head (2^-72 and 2^72 mod p), the word buffer is
    ``kernel_constants``' sections after p, section by section, each
    Montgomery value times 2^-72 mod p."""
    cfg = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, rate)
    fs, p = cfg.field, cfg.field.modulus
    w = [int(v) & _M32 for v in opt.word_constants(cfg)]
    values = [w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)]
    r_inv = pow(1 << 72, -1, p)
    assert values[:2] == [r_inv, (1 << 72) % p]
    off = 2
    sections = unpack_constants(cfg, st.PoseidonPermutation(cfg, "cpu").consts)
    assert list(sections)[1:] == ["ark", "mds", "chat", "row0", "col0", "dense"]
    for name, limbs in list(sections.items())[1:]:
        flat = limbs.reshape(-1, fs.nlimbs).T.numpy()  # (L, n)
        want = [v * r_inv % p for v in limbs_to_ints(fs, flat)]
        assert values[off : off + len(want)] == want, name
        off += len(want)
    assert off == len(values)


def test_launches_are_counted_by_body(monkeypatch):
    """``_launch``, kernel 1's one launch, adds each launch to
    ``permute_opt.launches`` and its body's count; a stand-in for
    ``_build.launch`` takes the arguments of each body, which fill the C
    entry's signature: a plain permutation, no rows, every row stored."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda symbol, state, out, *args, shape: calls.append((args, shape)))
    monkeypatch.setattr(opt.permute_opt, "launches", 0)
    monkeypatch.setattr(opt.permute_opt, "body_launches", dict.fromkeys(opt.BODIES, 0))
    gl = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8)
    bls = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    for cfg in (gl, gl, bls):
        perm = st.PoseidonPermutation(cfg, "cpu")
        state = state_plane(cfg, 4, 1)
        assert opt._launch(cfg, perm.consts, perm.opt_words, state, 0, (), (0, cfg.t), 4).shape == state.shape
    assert opt.permute_opt.launches == 3 and opt.permute_opt.body_launches == {"limb": 1, "two-word": 2}
    for (args, shape), cfg in zip(calls, (gl, gl, bls)):
        assert len(args) == len(_build.SIGNATURES["sponge_poseidon_opt"]) and shape == (cfg.t, cfg.field.nlimbs, 4)
        assert args[-13:] == (None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, cfg.t)


def test_smoke_census_names_each_body():
    """``chip_smoke.py`` finds kernel 1's instantiation per body: the limb
    body's (t, L) with the limb buffer staged, the two-word body's (t) with
    its word buffer."""
    import chip_smoke
    from sponge_tpu_torch.poseidon.config import constant_layout, layout_size

    bls, gl = (st.get_default_poseidon_parameters(getattr(st, f), r) for f, r in (("BLS12_381_FR", 2),
                                                                                  ("GOLDILOCKS_FR", 8)))
    name = "poseidon_permute_opt"
    assert chip_smoke.census_instance(name, bls) == ("poseidon_opt_kernel", (3, 11),
                                                     4 * layout_size(constant_layout(bls)))
    assert chip_smoke.census_instance(name, gl) == ("poseidon_opt_kernel", (12,), 4 * len(opt.word_constants(gl)))
    assert chip_smoke.opt_plan_text(gl) == "two-word body, largest accumulator 12 x 2^128"
    assert chip_smoke.opt_plan_text(bls).startswith("limb body, value bound")
