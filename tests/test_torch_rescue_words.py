"""Kernel 5's two-word body (``csrc/rescue_words.cu``): the Rescue
permutation at Goldilocks on one 64-bit word in plain form per element, in
Rescue-Prime's round order and in Rescue Prime Optimized's (the MDS first).

``Kernel5GL`` emulates the body word by word for one lane: the entry (the
stored value times 2^-72 mod p), in the config's order each half-round's
S-boxes (x^7 and Miden's inverse chain at alpha = 7, square-and-multiply
over the exponent's bits at any other alpha), its MDS rows (narrow: the
low and high 32-bit halves times the entries in two 64-bit accumulators,
reduced once; else the t 128-bit products reduced once by ``gl_reduce5``)
and its constants (``gl_add``), and the exit (the product by 2^72 mod p,
one conditional subtraction).  It is held, bit for bit, to
``rescue_permute_plain`` and to the scalar oracle at every Goldilocks width
kernel 5 runs, at RPO, with both orders and both row kinds, on lanes of 0,
1, p-1, p-2 and random lanes; every accumulator stays within its replay
(``ops/bounds.py`` ``check_rescue_gl_bounds``).  Then the replay's
refusals, the body choice over every default config, the launch arguments
(no fallback, no launch without the word buffer), the word buffer against
the limb buffer and the launch counts per body.  The card tests hold the
kernel to its plain version (RPO at 2^20 lanes) and skip without a card.
This file imports nothing of JAX."""

import dataclasses
import random
import types

import pytest
import torch

import sponge_tpu_torch as st
from sponge_tpu_torch.fields import ints_to_mont_tensor, limbs_to_ints, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import rescue as rescue_ops
from sponge_tpu_torch.ops.bounds import INV7_RUNS, RescueGLPlan, _RescueGLSim, check_rescue_gl_bounds
from sponge_tpu_torch.ops.rescue import rescue_permute, rescue_permute_plain, word_constants
from sponge_tpu_torch.rescue.config import unpack_constants

FS = st.GOLDILOCKS_FR
P = FS.modulus
_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1
_EPS = (1 << 32) - 1  # 2^64 mod p
RPO = st.get_rpo_parameters(FS)
LANES = 12  # lanes 0..7 put 0, 1, p-1, p-2 in every element position


class Kernel5GL:
    """``rescue_kernel<T, MdsFirst>`` of ``csrc/rescue_words.cu`` for one
    lane, on the stored (Montgomery form) values of the plane.  ``amax`` is
    the largest accumulator: a narrow row's low or high sum, or a
    ``gl_row`` sum's top word n4."""

    def __init__(self, cfg):
        self.cfg, self.amax = cfg, 0
        w = [int(v) & _M32 for v in word_constants(cfg)]
        values = iter([w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)])

        def take(rows, n):
            return [[next(values) for _ in range(n)] for _ in range(rows)]

        t = cfg.t
        (self.to_word, self.from_word, self.alpha, self.inv_alpha), = take(1, 4)
        self.rc, self.mds = take(2 * cfg.rounds, t), take(t, t)
        assert next(values, None) is None
        self.plan = check_rescue_gl_bounds(cfg)

    @staticmethod
    def reduce(n):
        """``GL_REDUCE_N``: V = lo - hh + hl (2^32 - 1) in 96 bits, its top
        word s (-1, 0 or 1) added back as s (2^32 - 1)."""
        assert 0 <= n < 1 << 128
        lo, hh, hl = n & _M64, n >> 96, (n >> 64) & _M32
        v = lo - hh + hl * _EPS
        s = v >> 64
        assert s in (-1, 0, 1)
        r = (v & _M64) + s * _EPS
        assert 0 <= r <= _M64
        return r

    def mul(self, a, b):
        assert a <= _M64 and b <= _M64
        return self.reduce(a * b)

    def sqr(self, a):
        return self.mul(a, a)

    @staticmethod
    def add(x, c):
        """``gl_add``: a carry out of 2^64 comes back as 2^32 - 1."""
        assert c < P
        s = x + c
        if s > _M64:
            s = s - (1 << 64) + _EPS
        assert s <= _M64
        return s

    def reduce5(self, n):
        """``gl_reduce5``: V = lo - n3 - n2 + (n2 - n4) 2^32, its top word s
        added back as s (2^32 - 1)."""
        assert 0 <= n < 1 << 160
        self.amax = max(self.amax, n >> 128)
        lo, n2, n3, n4 = n & _M64, (n >> 64) & _M32, (n >> 96) & _M32, n >> 128
        v = lo - n3 - n2 + (n2 - n4) * (1 << 32)
        s = v >> 64
        assert s in (-1, 0, 1)
        r = (v & _M64) + s * _EPS
        assert 0 <= r <= _M64
        return r

    def pow_bits(self, x, e):
        acc = x
        for bit in range(e.bit_length() - 2, -1, -1):
            acc = self.sqr(acc)
            if (e >> bit) & 1:
                acc = self.mul(acc, x)
        return acc

    def pow7(self, x):
        x2 = self.sqr(x)
        return self.mul(self.sqr(x2), self.mul(x2, x))

    def pow_inv7(self, x):
        """Miden's chain as ``gl_pow_inv7`` orders it: x^2, x^4, x^7 =
        x^2 x^4 x, then the runs of ``INV7_RUNS``."""
        x2 = self.sqr(x)
        power = {"x4": self.sqr(x2)}
        power["x7"] = self.mul(self.mul(x2, power["x4"]), x)
        acc = power["x4"]
        for (squarings, by), name in zip(INV7_RUNS, ("t3", "t4", "t5", "t6", "t7", "a", "out")):
            for _ in range(squarings):
                acc = self.sqr(acc)
            acc = power[name] = self.mul(acc, power[by])
        return acc

    def narrow(self, x, m):
        """``gl_narrow`` of the two accumulators of one row."""
        assert all(c <= _M32 for c in m)
        lo = sum((v & _M32) * c for v, c in zip(x, m))
        hi = sum((v >> 32) * c for v, c in zip(x, m))
        assert lo <= _M64 and hi <= _M64
        self.amax = max(self.amax, lo, hi)
        s = (lo + (hi << 32)) & _M64
        k = (hi >> 32) + int(s < lo)
        return self.add(s, (k << 32) - k)

    def affine(self, x, rc):
        if self.plan.narrow:
            y = [self.narrow(x, m) for m in self.mds]
        else:
            y = [self.reduce5(sum(a * b for a, b in zip(x, m))) for m in self.mds]
        return [self.add(v, c) for v, c in zip(y, rc)]

    def sbox(self, x, inverse):
        if self.plan.chain:
            return [self.pow_inv7(v) if inverse else self.pow7(v) for v in x]
        return [self.pow_bits(v, self.inv_alpha if inverse else self.alpha) for v in x]

    def permute(self, stored):
        """The stored values of one lane's t elements, permuted."""
        cfg = self.cfg
        x = [self.mul(v, self.to_word) for v in stored]
        for h in range(2 * cfg.rounds):
            if cfg.mds_first:
                x = self.affine(x, self.rc[h])
            x = self.sbox(x, inverse=bool(h % 2))
            if not cfg.mds_first:
                x = self.affine(x, self.rc[h])
        out = []
        for v in x:
            v = self.mul(v, self.from_word)
            v = v - P if v >= P else v
            assert v < P
            out.append(v)
        return out


def lane_values(t, lanes, seed):
    """[t][lanes] field elements; lanes 0..7 put 0, 1, p-1, p-2 in every
    element position, the rest random."""
    rng = random.Random(seed)
    edge = (0, 1, P - 1, P - 2)
    return [[edge[(b + e) % 4] if b < 4 else edge[(b // 2 + e) % 4] if b < 8 else rng.randrange(P)
             for b in range(lanes)] for e in range(t)]


def default_configs():
    """Every default Rescue-Prime config over the seven fields at rates 1-8."""
    out = {}
    for name in ("BLS12_381_FR", "BN254_FR", "BLS12_377_FR", "GOLDILOCKS_FR", "BABYBEAR_FR", "KOALABEAR_FR",
                 "MERSENNE31_FR"):
        fs = getattr(st, name)
        for rate in range(1, 9):
            try:
                out[f"{fs.name}-r{rate}"] = st.get_default_rescue_parameters(fs, rate)
            except ValueError:
                pass
    return out


def _flipped(cfg):
    return dataclasses.replace(cfg, mds_first=not cfg.mds_first)


# every Goldilocks width kernel 5 runs, RPO, each row kind in the other
# order, and an alpha other than 7 (square-and-multiply)
CONFIGS = {
    **{f"rescue-prime-t{r + 4}": (lambda r=r: st.get_default_rescue_parameters(FS, r)) for r in range(1, 9)},
    "rpo": lambda: RPO,
    "rpo-sbox-first": lambda: _flipped(RPO),
    "rescue-prime-t12-mds-first": lambda: _flipped(st.get_default_rescue_parameters(FS, 8)),
    "alpha-11-t8": lambda: st.generate_rescue_parameters(FS, 4, 4, alpha=11, rounds=3),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulation_equals_plain_and_oracle(name):
    """Each lane's words through the emulated body equal kernel 5's plain
    version (``rescue_permute_plain``, the CPU path of every caller) and
    the oracle's permutation, on lanes of 0, 1, p-1, p-2 and random lanes;
    every accumulator within the replay's."""
    cfg = CONFIGS[name]()
    assert rescue_ops.body(cfg) == "two-word" and (cfg.t, 3) in rescue_ops.BODIES["two-word"]
    vals = lane_values(cfg.t, LANES, cfg.t)
    state = ints_to_mont_tensor(FS, vals, "cpu")
    want = mont_tensor_to_ints(FS, rescue_permute_plain(cfg, st.RescuePermutation(cfg, "cpu").consts, state))
    kernel = Kernel5GL(cfg)
    r = FS.r % P
    got = [[v * pow(r, -1, P) % P for v in kernel.permute([vals[e][b] * r % P for e in range(cfg.t)])]
           for b in range(LANES)]
    assert [list(col) for col in zip(*got)] == want
    for b in range(LANES):
        oracle = st.OracleRescueSponge(cfg)
        oracle.state = [vals[e][b] for e in range(cfg.t)]
        oracle.permute()
        assert got[b] == oracle.state, b
    plan = check_rescue_gl_bounds(cfg)
    assert (plan.chain, plan.narrow) == (cfg.alpha == 7, name.startswith("rpo"))
    assert 0 < kernel.amax and (kernel.amax < plan.acc if plan.narrow else kernel.amax <= plan.acc)


def test_inverse_chain_is_midens():
    """63 squarings and 9 products raise to 1/7 mod p - 1, the exponent
    0x92492491b6db6db7, against the binary chain's 63 and 32."""
    counts = types.SimpleNamespace(sq=0, mul=0)

    class Count(Kernel5GL):
        def __init__(self):
            pass

        def sqr(self, a):
            counts.sq += 1
            return ("sq", a)

        def mul(self, a, b):
            counts.mul += 1
            return ("mul", a, b)

    def exponent(node):
        if node == "x":
            return 1
        return 2 * exponent(node[1]) if node[0] == "sq" else exponent(node[1]) + exponent(node[2])

    assert exponent(Count().pow_inv7("x")) == RPO.inv_alpha == 0x92492491B6DB6DB7
    assert (counts.sq, counts.mul) == (63, 9)
    assert (RPO.inv_alpha.bit_length() - 1, bin(RPO.inv_alpha).count("1") - 1) == (63, 32)


def test_replay_passes_every_default_goldilocks_config_and_rpo():
    """The eight default Goldilocks Rescue-Prime configs (t = 5..12) take
    alpha 7's chains and ``gl_row`` (their Grain MDS entries are full
    words), whose top word is t - 1; RPO takes narrow rows, its low and high
    sums below 160 (2^32 - 1) + 1, its largest row sum of entries 160."""
    gl = [cfg for cfg in default_configs().values() if cfg.field == FS]
    assert sorted(cfg.t for cfg in gl) == list(range(5, 13))
    for cfg in gl:
        assert check_rescue_gl_bounds(cfg) == RescueGLPlan(chain=True, narrow=False, acc=cfg.t - 1)
    assert max(sum(row) for row in RPO.mds) == 160
    assert check_rescue_gl_bounds(RPO) == RescueGLPlan(chain=True, narrow=True, acc=160 * _EPS + 1)


def _planted(t, mds=None, alpha=7):
    """A Goldilocks Rescue shape at width ``t`` for the replay alone (it
    reads the MDS only for narrow rows)."""
    return types.SimpleNamespace(field=FS, t=t, rounds=1, alpha=alpha, inv_alpha=pow(alpha, -1, P - 1),
                                 mds_first=False, mds=mds)


class _NoNarrowReduce(_RescueGLSim):
    """The replay with a narrow row left as lo + hi 2^32: the next product
    input is no word."""

    def narrow(self, x):
        return ((x[0] - 1) & _M32) * self.row_sum + ((x[0] - 1) >> 32) * self.row_sum * (1 << 32) + 1, 1


REFUSALS = {
    "rows-reach-2^160": (lambda: _RescueGLSim(_planted((1 << 32) + 2), narrow=False).run(),
                         "a row sum can reach 2\\^160"),
    "narrow-reaches-2^64": (lambda: _RescueGLSim(_planted(3, ((1 << 31,) * 3,) * 3), narrow=True).run(),
                            "accumulator can reach 2\\^64"),
    "narrow-entry-no-word": (lambda: _RescueGLSim(_planted(2, ((1 << 32, 1), (1, 1))), narrow=True).run(),
                             "no 32-bit word"),
    "not-goldilocks": (lambda: check_rescue_gl_bounds(st.get_default_rescue_parameters(st.BABYBEAR_FR, 8)),
                       "2\\^64 - 2\\^32"),
    "no-narrow-reduce": (lambda: _NoNarrowReduce(RPO, narrow=True).run(), "can reach 2\\^"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_replay_refuses_planted_overflows(name):
    """The replay refuses a width whose ``gl_row`` sums can reach 2^160,
    narrow rows whose accumulators can reach 2^64 or whose entries are no
    32-bit words, a field other than Goldilocks, and a schedule whose
    narrow rows are not reduced."""
    check, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        check()


def test_replay_falls_back_to_full_rows():
    """An MDS with an entry of 2^32 or more, or with entries whose narrow
    sums could pass 2^64, takes ``gl_row``; one of small entries the narrow
    rows."""
    base = st.get_default_rescue_parameters(FS, 4)
    small = dataclasses.replace(base, mds=tuple(tuple((i + j) % 8 + 1 for j in range(8)) for i in range(8)))
    assert check_rescue_gl_bounds(small).narrow
    wide = dataclasses.replace(small, mds=((1 << 32,) + small.mds[0][1:],) + small.mds[1:])
    assert not check_rescue_gl_bounds(wide).narrow
    heavy = dataclasses.replace(small, mds=tuple(tuple(1 << 29 for _ in range(8)) for _ in range(8)))
    assert not check_rescue_gl_bounds(heavy).narrow


def test_body_choice_for_every_default_config():
    """All 56 default configs: the two-word body at Goldilocks t = 5..12,
    the limb body elsewhere; each body's pair is compiled and the pairs make
    up ``_build.INSTANTIATIONS``; only the two-word body has a word
    buffer."""
    assert rescue_ops.BODIES["limb"] | rescue_ops.BODIES["two-word"] == _build.INSTANTIATIONS["sponge_rescue"]
    assert not rescue_ops.BODIES["limb"] & rescue_ops.BODIES["two-word"]
    assert rescue_ops.MDS_FIRST_PAIRS <= rescue_ops.BODIES["two-word"]
    configs = default_configs()
    assert len(configs) == 56
    for label, cfg in configs.items():
        kind = rescue_ops.body(cfg)
        assert kind == ("two-word" if cfg.field == FS else "limb"), label
        assert (cfg.t, cfg.field.nlimbs) in rescue_ops.BODIES[kind], label
        words = 2 * (4 + 2 * cfg.rounds * cfg.t + cfg.t ** 2)
        assert len(word_constants(cfg)) == (words if kind == "two-word" else 0), label
    counts = {k: sum(rescue_ops.body(c) == k for c in configs.values()) for k in rescue_ops.BODIES}
    assert counts == {"limb": 48, "two-word": 8}
    assert rescue_ops.body(RPO) == "two-word"


def test_launch_args_by_body():
    """The limb body's arguments end in body 0 and no word buffer; the
    two-word body's in body 2, the module's ``words`` buffer and its length,
    its chains and its rows, and it refuses a missing, short, long or
    misplaced buffer.  A 60-bit field at (12, 3), the two-word body's pair,
    takes the limb body, which lacks the pair: NotImplementedError, no
    fallback."""
    perm = st.RescuePermutation(RPO, "cpu")
    consts, words = perm.consts, perm.words
    args = rescue_ops._launch_args(RPO, consts, words)
    assert len(args) == len(_build.SIGNATURES["sponge_rescue"])
    assert args[5:] == (consts.data_ptr(), FS.n0inv, 1, 2, words.data_ptr(), len(word_constants(RPO)), 1, 1)
    assert torch.equal(words, torch.from_numpy(word_constants(RPO)))
    for bad in (None, words[1:], torch.cat([words, words[:2]]), words.to("meta")):
        with pytest.raises(ValueError, match="word_constants"):
            rescue_ops._launch_args(RPO, consts, bad)
    rp = st.get_default_rescue_parameters(FS, 8)
    rp_perm = st.RescuePermutation(rp, "cpu")
    assert rescue_ops._launch_args(rp, rp_perm.consts, rp_perm.words)[-6:] == (
        0, 2, rp_perm.words.data_ptr(), rp_perm.words.numel(), 1, 0)
    bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    bls_perm = st.RescuePermutation(bls, "cpu")
    assert bls_perm.words.numel() == 0
    assert rescue_ops._launch_args(bls, bls_perm.consts, None)[-5:] == (0, None, 0, 0, 0)
    fs60 = st.FieldSpec(name="f60", modulus=(1 << 60) - 93, generator=2)
    other = dataclasses.replace(rp, field=fs60, rc=tuple(tuple(v % fs60.modulus for v in r) for r in rp.rc),
                                mds=tuple(tuple(v % fs60.modulus for v in r) for r in rp.mds))
    assert (other.t, other.field.nlimbs) == (12, 3) and rescue_ops.body(other) == "limb"
    with pytest.raises(NotImplementedError, match="kernel 5's limb body"):
        rescue_ops._launch_args(other, st.RescuePermutation(other, "cpu").consts, None)


@pytest.mark.parametrize("name", ["rescue-prime-t12", "rpo"])
def test_word_constants_are_the_limb_buffer_in_plain_form(name):
    """Past its head (2^-72 and 2^72 mod p, alpha, 1/alpha), the word
    buffer is ``kernel_constants``' rc and MDS sections, each Montgomery
    value times 2^-72 mod p."""
    cfg = CONFIGS[name]()
    w = [int(v) & _M32 for v in word_constants(cfg)]
    values = [w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)]
    r_inv = pow(1 << 72, -1, P)
    assert values[:4] == [r_inv, (1 << 72) % P, cfg.alpha, cfg.inv_alpha]
    off = 4
    sections = unpack_constants(cfg, st.RescuePermutation(cfg, "cpu").consts)
    for section in ("rc", "mds"):
        flat = sections[section].reshape(-1, FS.nlimbs).T.numpy()  # (L, n)
        want = [v * r_inv % P for v in limbs_to_ints(FS, flat)]
        assert values[off : off + len(want)] == want, section
        off += len(want)
    assert off == len(values)


def test_launches_are_counted_by_body(monkeypatch):
    """``rescue_permute`` adds each launch to its body's count, and a CPU
    tensor (the plain version) to none: a stand-in for ``_build.run``
    launches as the card would, with the wrapper's arguments."""
    monkeypatch.setattr(rescue_permute, "launches", 0)
    monkeypatch.setattr(rescue_permute, "body_launches", dict.fromkeys(rescue_ops.BODIES, 0))
    perm = st.RescuePermutation(RPO, "cpu")
    rescue_permute(RPO, perm.consts, ints_to_mont_tensor(FS, lane_values(12, 2, 1), "cpu"), perm.words)
    assert rescue_permute.body_launches == {"limb": 0, "two-word": 0}
    seen = []

    def fake_run(wrapper, symbol, cfg, consts, state, layout, plain, launch_args):
        seen.append(launch_args(cfg, consts))
        wrapper.launches += 1
        return state

    monkeypatch.setattr(_build, "run", fake_run)
    bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    for cfg in (RPO, RPO, bls):
        module = st.RescuePermutation(cfg, "cpu")
        module.kernel(cfg, module.consts, torch.zeros((cfg.t, cfg.field.nlimbs, 4), dtype=torch.int32))
    assert rescue_permute.launches == 3 and rescue_permute.body_launches == {"limb": 1, "two-word": 2}
    assert [args[8] for args in seen] == [2, 2, 0]


def test_smoke_census_names_each_body():
    """``chip_smoke.py`` finds kernel 5's instantiation per body: the limb
    body's (t, L, order) with its window table, the two-word body's (t,
    order) with its word buffer staged."""
    import chip_smoke
    from sponge_tpu_torch.ops.montgomery import window_table_bytes
    from sponge_tpu_torch.rescue.config import windows

    bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    assert chip_smoke.census_instance("rescue_permute", bls) == (
        "rescue_kernel", (3, 11, 0), window_table_bytes(3, 11, max(windows(bls))))
    assert chip_smoke.census_instance("rescue_permute", RPO) == ("rescue_kernel", (12, 1), 4 * len(word_constants(RPO)))
    rp = st.get_default_rescue_parameters(FS, 4)
    assert chip_smoke.census_instance("rescue_permute", rp) == ("rescue_kernel", (8, 0), 4 * len(word_constants(rp)))


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", ["rpo", "rescue-prime-t12", "alpha-11-t8"])
def test_kernel_equals_its_plain_version_on_the_card(cuda, name):
    """The two-word body at 2^20 lanes (RPO; the narrow rows and the fixed
    chains), 2^16 lanes (Rescue-Prime t = 12, ``gl_row``; alpha 11, the
    rolled chains), with 0, 1, p-1, p-2 in the first lanes, against the
    plain version on the same card, counted as a two-word launch."""
    cfg = CONFIGS[name]()
    lanes = 1 << (20 if name == "rpo" else 16)
    gen = torch.Generator().manual_seed(lanes + cfg.t)
    # canonical limbs: a top limb below 2^16 - 1 keeps every value below p
    state = torch.stack([torch.randint(0, hi, (cfg.t, lanes), generator=gen, dtype=torch.int32)
                         for hi in (1 << 24, 1 << 24, (1 << 16) - 1)], dim=1)
    state[:, :, :8] = ints_to_mont_tensor(FS, lane_values(cfg.t, 8, 0), "cpu")
    state = state.to(cuda)
    perm = st.RescuePermutation(cfg, cuda)
    before = dict(rescue_permute.body_launches)
    out = perm(state, "kernel")
    assert rescue_permute.body_launches["two-word"] == before["two-word"] + 1
    assert torch.equal(out, rescue_permute_plain(cfg, perm.consts, state))


def test_smoke_bound_counts_the_benchmarks_products():
    """``chip_smoke.py``'s count of the two-word body's wide products is the
    benchmark's (``spongebench/families/rescue.py``: narrow rows at RPO)
    plus the entry's and the exit's 2 t products; Rescue-Prime's ``gl_row``
    rows count 4 t a row."""
    import json

    import chip_smoke
    from spongebench.families.rescue import permutation_products

    config = json.loads((_build.CSRC.parents[1] / "spongebench/configs/gl-rpo-t12.json").read_text())
    t = RPO.t
    assert chip_smoke.limb_products("rescue_permute", RPO) == (permutation_products(config) + 4 * 2 * t, 0)
    rp = st.get_default_rescue_parameters(FS, 8)
    assert chip_smoke.limb_products("rescue_permute", rp) == (
        permutation_products(dict(config, rounds=rp.rounds)) + rp.rounds * 2 * t * 2 * t + 4 * 2 * t, 0)
