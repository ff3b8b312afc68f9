"""On-card smoke test of the PyTorch/CUDA port (sponge_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from sponge_tpu_torch/csrc with nvcc (one nvcc
per source, in parallel): Poseidon (kernels 1 and 2), Poseidon2 (kernel 3),
Rescue-Prime (kernel 5), Griffin-pi (kernel 6), Anemoi (kernel 7) and
GMiMC-erf (kernel 8).  It holds each kernel against its plain PyTorch
version (torch.equal, with 0, 1, p-1, p-2 in every element position) and
the scalar oracle, checks the golden vectors through the sponge on the card,
drives three paths at full size with the launch counters zeroed just before
each and read just after (Poseidon: the batched BLS12-381 Fr rate-2
permutation at B = 2^20, the lazy sponge, a 2^20-leaf Merkle root; Poseidon2
and Rescue: the BLS12-381 and BabyBear permutations at B = 2^20, a 2^20-leaf
Poseidon2 Merkle root, a lazy Rescue sponge; GMiMC, Griffin and Anemoi: the
BLS12-381 and Goldilocks permutations at B = 2^20, a lazy GMiMC sponge, a
2^14-leaf Griffin Merkle root), and times each kernel beside its plain
version with CUDA events.  The plain version's timed run takes the path's
own 2^20-lane input (for the BLS12-381 inverse-S-box families, Rescue,
Griffin and Anemoi, 2^14 lanes from both ends of it) and must equal the
path's output there.  Each kernel's bound is the
larger of the limb products the function needs (``limb_products``) over
the card's 32-bit integer multiply-add rate and its state bytes over the
memory rate.  Each phase prints one line; any
failure raises and exits non-zero.  Before the last line come a JSON summary
of the kernels and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.  It imports nothing of JAX or sponge_tpu.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260516
B_MAIN = 1 << 20
B_CHECK = 1 << 16
# BLS12-381 configs with a 254-bit inverse S-box run some 10^4 Montgomery
# products per plain permutation, each tens of small tensor ops: launch-bound
B_LADDER_PLAIN = 1 << 14

# H100 rates for the bound: 132 SMs x 64 32-bit integer multiply-adds per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) at the card's maximum SM clock, and
# 3.35 TB/s of HBM3.
SMS, IMAD_PER_CLOCK, HBM_BYTES_PER_S = 132, 64, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120).stdout.strip()


def tiny_config(st):
    """The 35-bit test field config (tests/conftest.py's tiny_poseidon_config
    with alpha = 17, R_F = 8, R_P = 8, seed 11), rebuilt without JAX."""
    fs = st.FieldSpec(name="tiny_fr_35", modulus=(1 << 35) - 31, generator=3)
    rng = np.random.default_rng(11)
    draw = lambda: int(rng.integers(0, 1 << 62)) % fs.modulus
    ark = tuple(tuple(draw() for _ in range(3)) for _ in range(16))
    mds = tuple(tuple(draw() for _ in range(3)) for _ in range(3))
    return st.PoseidonConfig(
        field=fs, full_rounds=8, partial_rounds=8, alpha=17, ark=ark, mds=mds, rate=2
    )


def random_plane(fs, shape, rng, device):
    """Canonical Montgomery plane of shape (..., L, B): random 24-bit limbs,
    the top limb below p's, so every value is below p."""
    limbs = rng.integers(0, 1 << 24, size=shape, dtype=np.int64)
    top = fs.modulus >> (24 * (fs.nlimbs - 1))
    limbs[..., -1, :] = rng.integers(0, top, size=limbs[..., -1, :].shape)
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def with_edges(fs, plane):
    """Put 0, 1, p-1, p-2 in every element position: over lanes 0..63 the
    first three elements run all 4^3 combinations, element e >= 3 cycles
    through the four values."""
    edges = [fs.ints_to_mont_plane([v])[:, 0] for v in (0, 1, fs.modulus - 1, fs.modulus - 2)]
    plane = plane.clone()
    for b in range(64):
        for e in range(plane.shape[0]):
            k = (b >> (2 * e)) & 3 if e < 3 else (b + e) & 3
            plane[e, :, b] = torch.from_numpy(edges[k])
    return plane


def lane_ints(fs, plane, b):
    return [fs.mont_plane_to_ints(plane[e, :, b : b + 1].cpu().numpy())[0] for e in range(plane.shape[0])]


def oracle_for(cfg):
    """A fresh scalar oracle sponge of the config's family."""
    import sponge_tpu_torch as st

    if isinstance(cfg, st.PoseidonConfig):
        return st.OraclePoseidonSponge(cfg)
    return cfg.oracle_sponge()


def oracle_permute(cfg, vals):
    o = oracle_for(cfg)
    o.state = list(vals)
    o.permute()
    return o.state


def check_lanes_vs_oracle(cfg, state_in, state_out, lanes, what):
    for b in lanes:
        want = oracle_permute(cfg, lane_ints(cfg.field, state_in, b))
        check(lane_ints(cfg.field, state_out, b) == want, f"{what}: lane {b} differs from the oracle")


def time_ms(fn, reps=3):
    """(CUDA-event time of fn(): one warm call, then the best of ``reps``;
    the last call's result)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best, out


def value_bound_text(cfg, vmax):
    fs = cfg.field
    return f"value bound {vmax / fs.modulus:.1f}p of R = {fs.r / fs.modulus:.1f}p"


def plan_text(cfg, plan):
    """A family kernel's replay (``ops/bounds.py`` ``KernelPlan``)."""
    return (f"{value_bound_text(cfg, plan.vmax)}, largest limb word {plan.wmax / 2**24:.1f} x 2^24, "
            f"reduction {'on' if plan.reduce else 'off'}")


def chain_products(e, sq, mul):
    """Fewest limb products of x^e over left-to-right sliding-window chains
    (windows of 1 to 8 bits), a squaring costing ``sq`` and a multiply
    ``mul``: the table x^2, x^3, x^5, ... up to the largest window used, then
    one squaring per bit after the first window and one multiply per further
    window.  Window 1 is square-and-multiply."""
    bits, best = bin(e)[2:], None
    for w in range(1, 9):
        n_sq = n_mul = top = 0
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                n_sq, i = n_sq + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            top = max(top, int(bits[i:j], 2))
            if not first:
                n_sq, n_mul = n_sq + j - i, n_mul + 1
            first, i = False, j
        if top > 1:
            n_sq, n_mul = n_sq + 1, n_mul + (top - 1) // 2
        cost = n_sq * sq + n_mul * mul
        best = cost if best is None else min(best, cost)
    return best


def limb_products(name, cfg):
    """Integer multiplies one permutation needs on limbs (the bound's work,
    not any kernel's schedule): a Montgomery product is 2 L^2 limb products
    (a * b and the REDC's q * p), a squaring L (L + 1) / 2 + L^2, a lazily
    summed row dot (t + 1) L^2; each power x^e takes its cheapest window
    chain (``chain_products``).  Poseidon2's small-integer matrix entries
    and diagonal scalings are one 32-bit multiply per limb, and it takes only
    the rho-folds its values need (``P2Plan.min_folds``), L each."""
    from sponge_tpu_torch.ops.bounds import check_anemoi_bounds, check_griffin_bounds, p2_plan

    t, L = cfg.t, cfg.field.nlimbs
    mm, sq, row = 2 * L * L, L * (L + 1) // 2 + L * L, (t + 1) * L * L
    sb = chain_products(cfg.alpha, sq, mm)
    if name in ("poseidon_permute_opt", "poseidon_permute_dense"):
        full = cfg.full_rounds * (t * sb + t * row)
        if name == "poseidon_permute_dense":
            return full + cfg.partial_rounds * (sb + t * row)
        sparse = (cfg.partial_rounds - 1) * (row + (t - 1) * mm + sb)
        return full + sb + sparse + t * row
    if name == "poseidon2_permute":
        ext = t * sb + t * t * L
        internal = sb + (t * L if cfg.small_diag else t * mm)
        folds = p2_plan(cfg).min_folds * L
        return t * t * L + cfg.full_rounds * ext + cfg.partial_rounds * internal + folds + t * mm
    if name == "rescue_permute":
        per_round = t * (sb + chain_products(cfg.inv_alpha, sq, mm)) + 2 * t * row
        return cfg.rounds * per_round + t * mm
    if name == "gmimc_permute":  # the deferred adds are not products
        return cfg.rounds * sb + t * mm
    if name == "griffin_permute":
        # gates: (i-1) y0 scaled limb by limb, L_i^2, alpha_i L_i, x_i quad;
        # the post-linear reduction only where the plan needs it
        gates = sum((L if i >= 3 else 0) + sq + 2 * mm for i in range(2, t))
        linear = t * t * L + (t * mm if check_griffin_bounds(cfg).reduce else 0)
        per_round = chain_products(cfg.inv_alpha, sq, mm) + sb + gates
        return (cfg.rounds + 1) * linear + cfg.rounds * per_round + t * mm
    if name == "anemoi_permute":
        # per pair: y^2, g y^2, u^(1/alpha), v^2, g v^2 (subtractions are
        # additions); M_x rows lazily summed where l > 1; the post-PHT
        # reduction only where the plan needs it
        lc = cfg.l
        diffusion = (2 * lc * (lc + 1) * L * L if lc > 1 else 0) + (
            t * mm if check_anemoi_bounds(cfg).reduce else 0
        )
        per_round = lc * (2 * sq + 2 * mm + chain_products(cfg.inv_alpha, sq, mm)) + diffusion
        return cfg.rounds * per_round + diffusion + t * mm
    raise ValueError(name)


def bound(name, cfg, batch, sm_clock_hz):
    """(bound_ms, bound_by) of one call at ``batch`` lanes."""
    ops_ms = limb_products(name, cfg) * batch / (SMS * IMAD_PER_CLOCK * sm_clock_hz) * 1e3
    bytes_ms = 2 * cfg.t * cfg.field.nlimbs * 4 * batch / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2

    import sponge_tpu_torch as st
    from sponge_tpu_torch.fields import mont_tensor_to_ints
    from sponge_tpu_torch.hash import compress_pairs, merkle_root
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.anemoi import anemoi_permute, anemoi_permute_plain
    from sponge_tpu_torch.ops.bounds import (
        check_anemoi_bounds,
        check_gmimc_bounds,
        check_griffin_bounds,
        check_kernel_bounds,
        check_rescue_bounds,
        p2_plan,
    )
    from sponge_tpu_torch.ops.gmimc import gmimc_permute, gmimc_permute_plain
    from sponge_tpu_torch.ops.griffin import griffin_permute, griffin_permute_plain
    from sponge_tpu_torch.ops.poseidon2 import permute_p2, permute_p2_plain
    from sponge_tpu_torch.ops.poseidon_dense import permute_dense, permute_dense_plain
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt, permute_opt_plain
    from sponge_tpu_torch.ops.rescue import rescue_permute, rescue_permute_plain
    from sponge_tpu_torch.family import permutation_for as family_permutation_for
    from sponge_tpu_torch.poseidon.permutation import permutation_for

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # ---- 1. environment and build ----
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    sm_mhz = run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    sm_clock_hz = float(sm_mhz.splitlines()[0]) * 1e6
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    say("env", "nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    say("env", f"card: {gpu}; max SM clock {sm_mhz} MHz")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say("build", f"{lib_path.name} (sm_90a) ready in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say("ptxas", line.strip())

    bls = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    bn = st.get_default_poseidon_parameters(st.BN254_FR, 2)
    tiny = tiny_config(st)
    tiny_fs = tiny.field
    low_fs = st.FieldSpec(name="low_headroom_44", modulus=(1 << 44) - 17, generator=3)
    fr25 = st.FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
    p2_bls = st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2)
    p2_bn = st.get_default_poseidon2_parameters(st.BN254_FR, 2)
    p2_bb = st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8)
    p2_tiny = st.generate_poseidon2_parameters(tiny_fs, 2, 5, 4, 8)
    p2_low = st.generate_poseidon2_parameters(low_fs, 7, 5, 4, 4)
    r_bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    r_bb = st.get_default_rescue_parameters(st.BABYBEAR_FR, 8)
    r_25 = st.generate_rescue_parameters(fr25, 2, rounds=4)
    gl = st.GOLDILOCKS_FR
    m_bls = st.get_default_gmimc_parameters(st.BLS12_381_FR, 2)
    m_gl = st.get_default_gmimc_parameters(gl, 4)
    m_25 = st.generate_gmimc_parameters(fr25, 2, rounds=31)
    g_bls = st.get_default_griffin_parameters(st.BLS12_381_FR, 2)
    g_gl = st.get_default_griffin_parameters(gl, 4)
    g_25 = st.generate_griffin_parameters(fr25, 2, rounds=5)
    a_bls = st.get_default_anemoi_parameters(st.BLS12_381_FR, 3)
    a_bls1 = st.get_default_anemoi_parameters(st.BLS12_381_FR, 1)
    a_gl = st.get_default_anemoi_parameters(gl, 4)
    a_25 = st.generate_anemoi_parameters(fr25, 3, rounds=5)
    ladder_plain = {id(c) for c in (r_bls, g_bls, a_bls, a_bls1)}  # plain runs at B_LADDER_PLAIN

    # ---- 2. golden vectors through the sponge on the card ----
    goldens = [
        ("Poseidon", bls, [0, 1, 2], 3,
         [40442793463571304028337753002242186710310163897048962278675457993207843616876]),
        ("Poseidon2", p2_bls, [0, 1, 2], 3,
         [52083961829638530329803873513984423317950149524710559639711710544245016843101,
          46550625866894159897150880606355238520431023163927606006962896442099973167881,
          42226209967555737499361210161376034319861506751659560949906643713058884560743]),
        ("Rescue-Prime", r_bls, [0, 1], 2,
         [45302786381541930325162575638737089225573393886344434601026979521681543727945,
          26952253882373158469686854567157364530461338720960972120602142787680627985088]),
        ("GMiMC", m_bls, [0, 1], 2,
         [37046578519137793905068004997922276005969922553874139160809393105572205846096,
          36927340725794352549314907498009288447328445793911509161713498516543876008544]),
        ("Griffin", g_bls, [0, 1], 2,
         [17568489372357836836505885331655087491470577238226034896877593231157640869808,
          14593224294559100415741393686604387315592950665506024215387915292647432429441]),
        ("Anemoi", a_bls1, [0], 2,
         [35675714314881219429352217523578393221143023524104408084397769653631559795453,
          29250560957318018735580408678162621932017287796996990149206325536109642299737]),
        ("GMiMC", m_gl, [0, 1, 2, 3], 2, [2530300686986820728, 5710632959018033549]),
        ("Griffin", g_gl, [0, 1, 2, 3], 2, [5142094782954152270, 13580507934772854974]),
        ("Anemoi", a_gl, [0, 1, 2, 3], 2, [8816711172724677702, 3319201661018352774]),
    ]
    for family, cfg, absorbed, n, golden in goldens:
        s = st.PoseidonSponge(cfg, batch_size=4, device=dev)
        s.absorb([st.Fp(v, cfg.field) for v in absorbed])
        got = s.squeeze_native_field_elements(n)
        check(all(lane[: len(golden)] == golden for lane in got), f"{family} golden vector: got {got[0]}")
        say("golden", f"{family} {cfg.field.name} rate {cfg.rate}: sponge squeeze == {golden[0]}... on all 4 lanes")
    fix = st.poseidon_test_fixture()
    left, right = random_plane(fix.field, (2, fix.field.nlimbs, 64), rng, dev)
    out = mont_tensor_to_ints(fix.field, compress_pairs(fix, left, right))
    ls, rs = mont_tensor_to_ints(fix.field, left), mont_tensor_to_ints(fix.field, right)
    for b in range(64):
        o = st.OraclePoseidonSponge(fix)
        o.absorb_field_elements([ls[b], rs[b]])
        check(out[b] == o.squeeze_native_field_elements(1)[0], f"fixture lane {b}")
    say("golden", "reference test fixture (R_P = 29): 64 compressions == oracle")

    # ---- 3. each kernel against its plain version ----
    kernels = {
        "poseidon_permute_opt": dict(
            wrapper=permute_opt, plain=permute_opt_plain, perm=permutation_for,
            bound=lambda cfg: value_bound_text(cfg, check_kernel_bounds(cfg, True)),
            configs=[bls, bn, tiny],
            source="sponge_tpu_torch/csrc/poseidon_opt.cu",
            replaces="sponge_tpu/ops/pallas_cios.py:1248",
        ),
        "poseidon_permute_dense": dict(
            wrapper=permute_dense, plain=permute_dense_plain, perm=permutation_for,
            bound=lambda cfg: value_bound_text(cfg, check_kernel_bounds(cfg, False)),
            configs=[bls, bn, tiny],
            source="sponge_tpu_torch/csrc/poseidon_dense.cu",
            replaces="sponge_tpu/ops/pallas_permute.py:96",
        ),
        "poseidon2_permute": dict(
            wrapper=permute_p2, plain=permute_p2_plain,
            perm=functools.partial(family_permutation_for, st.Poseidon2Permutation),
            bound=lambda cfg: (
                f"folds per site {p2_plan(cfg).folds}, largest value before a fold "
                f"{p2_plan(cfg).vmax / cfg.field.r:.1f}R, largest limb word "
                f"{p2_plan(cfg).wmax / 2**24:.1f} x 2^24"
            ),
            configs=[p2_bls, p2_bn, p2_bb, p2_tiny, p2_low],
            source="sponge_tpu_torch/csrc/poseidon2.cu",
            replaces="sponge_tpu/ops/pallas_p2.py:314",
        ),
        "rescue_permute": dict(
            wrapper=rescue_permute, plain=rescue_permute_plain,
            perm=functools.partial(family_permutation_for, st.RescuePermutation),
            bound=lambda cfg: value_bound_text(cfg, check_rescue_bounds(cfg)),
            configs=[r_bls, r_bb, r_25],
            source="sponge_tpu_torch/csrc/rescue.cu",
            replaces="sponge_tpu/ops/pallas_rescue.py:438",
        ),
        "griffin_permute": dict(
            wrapper=griffin_permute, plain=griffin_permute_plain,
            perm=functools.partial(family_permutation_for, st.GriffinPermutation),
            bound=lambda cfg: plan_text(cfg, check_griffin_bounds(cfg)),
            configs=[g_bls, g_gl, g_25],
            source="sponge_tpu_torch/csrc/griffin.cu",
            replaces="sponge_tpu/ops/pallas_griffin.py:334",
        ),
        "anemoi_permute": dict(
            wrapper=anemoi_permute, plain=anemoi_permute_plain,
            perm=functools.partial(family_permutation_for, st.AnemoiPermutation),
            bound=lambda cfg: plan_text(cfg, check_anemoi_bounds(cfg)),
            configs=[a_bls, a_bls1, a_gl, a_25],
            source="sponge_tpu_torch/csrc/anemoi.cu",
            replaces="sponge_tpu/ops/pallas_anemoi.py:372",
        ),
        "gmimc_permute": dict(
            wrapper=gmimc_permute, plain=gmimc_permute_plain,
            perm=functools.partial(family_permutation_for, st.GmimcPermutation),
            bound=lambda cfg: plan_text(cfg, check_gmimc_bounds(cfg)),
            configs=[m_bls, m_gl, m_25],
            source="sponge_tpu_torch/csrc/gmimc.cu",
            replaces="sponge_tpu/ops/pallas_gmimc.py:150",
        ),
    }
    for k in kernels.values():
        k["max_abs_err"] = 0
    for name, k in kernels.items():
        for cfg in k["configs"]:
            B = B_LADDER_PLAIN if id(cfg) in ladder_plain else B_CHECK
            perm = k["perm"](cfg, dev)
            state = with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B), rng, dev))
            bound_text = k["bound"](cfg)
            out_k = k["wrapper"](cfg, perm.consts, state)
            torch.cuda.synchronize()
            out_p = k["plain"](cfg, perm.consts, state)
            err = int((out_k.long() - out_p.long()).abs().max())
            k["max_abs_err"] = max(k["max_abs_err"], err)
            check(torch.equal(out_k, out_p), f"{name} != plain on {cfg.field.name} t={cfg.t} (max err {err})")
            sample = list(range(0, 64, 2)) + sorted(rng.choice(np.arange(64, B), 32, replace=False).tolist())
            check_lanes_vs_oracle(cfg, state, out_k, sample, f"{name} {cfg.field.name}")
            say(
                "kernel",
                f"{name} {cfg.field.name} t={cfg.t} L={cfg.field.nlimbs}: torch.equal(kernel, plain) "
                f"at B={B} incl. 64 edge lanes; 64 lanes == oracle; {bound_text}",
            )

    # ---- 4. the Poseidon path (kernels 1 and 2), launches counted ----
    fs = bls.field
    perm = permutation_for(bls, dev)
    state = with_edges(fs, random_plane(fs, (bls.t, fs.nlimbs, B_MAIN), rng, dev))
    leaves = random_plane(fs, (fs.nlimbs, B_MAIN), rng, dev)
    lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    out = st.batched_permute(bls, state)  # kernel 1
    parity = st.batched_permute(bls, state, backend="dense")  # kernel 2: the second parity tier
    sponge = st.PoseidonSponge(bls, batch_size=B_CHECK, device=dev)
    sponge.absorb(b"chip smoke transcript")
    sponge.absorb(st.U64(7))
    sponge.absorb([st.Fp(11, fs), st.Fp(fs.modulus - 1, fs)])
    sponge.absorb_element_plane(lane_vals)
    squeezed = sponge.squeeze_native_field_elements(3)
    sq_bytes = sponge.squeeze_bytes(40)
    sq_bits = sponge.squeeze_bits(300)
    root = merkle_root(bls, leaves)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in ("poseidon_permute_opt", "poseidon_permute_dense"):
        check(launches[name] > 0, f"{name} was not launched on the Poseidon path")
    say("launches", "Poseidon path: " + json.dumps(launches))

    check(out.shape == state.shape and torch.equal(out, parity), "kernel 1 != kernel 2 at B = 2^20")
    main_sample = list(range(0, 64, 2)) + sorted(rng.choice(np.arange(64, B_MAIN), 32, replace=False).tolist())
    check_lanes_vs_oracle(bls, state, out, main_sample, "batched_permute B=2^20")
    say("main", f"batched_permute {fs.name} rate 2 at B=2^20: kernel 1 == kernel 2; 64 lanes == oracle")

    vals = [mont_tensor_to_ints(fs, lane_vals[i]) for i in range(2)]
    for b in list(range(4)) + [B_CHECK // 2, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
        o = st.OraclePoseidonSponge(bls)
        o.absorb(b"chip smoke transcript")
        o.absorb(st.U64(7))
        o.absorb([st.Fp(11, fs), st.Fp(fs.modulus - 1, fs)])
        o.absorb_field_elements([vals[0][b], vals[1][b]])
        check(squeezed[b] == o.squeeze_native_field_elements(3), f"sponge lane {b}: native squeeze")
        check(sq_bytes[b] == o.squeeze_bytes(40), f"sponge lane {b}: squeeze_bytes")
        check(sq_bits[b] == o.squeeze_bits(300), f"sponge lane {b}: squeeze_bits")
    say("sponge", f"lazy PoseidonSponge B={B_CHECK}: native/bytes/bits squeezes == oracle on 8 lanes")

    check_merkle(bls, leaves, root, "Poseidon")

    # ---- 5. the Poseidon2 and Rescue-Prime path (kernels 3 and 5), launches counted ----
    p2_states = {
        cfg.field.name: with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
        for cfg in (p2_bls, p2_bb)
    }
    r_state = with_edges(fs, random_plane(fs, (r_bls.t, fs.nlimbs, B_MAIN), rng, dev))
    p2_leaves = random_plane(fs, (fs.nlimbs, B_MAIN), rng, dev)
    r_lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    p2_out = {cfg.field.name: st.batched_permute(cfg, p2_states[cfg.field.name]) for cfg in (p2_bls, p2_bb)}
    p2_root = merkle_root(p2_bls, p2_leaves)
    r_out = st.batched_permute(r_bls, r_state)
    r_sponge = st.LazyPoseidonSponge(r_bls, batch_size=B_CHECK, device=dev)
    r_sponge.absorb(b"rescue transcript")
    r_sponge.absorb([st.Fp(5, fs), st.Fp(fs.modulus - 2, fs), st.Fp(0, fs)])
    r_sponge.absorb_element_plane(r_lane_vals)
    r_squeezed = r_sponge.squeeze_native_field_elements(3)
    r_bytes = r_sponge.squeeze_bytes(50)
    r_bits = r_sponge.squeeze_bits(260)
    torch.cuda.synchronize()
    launches2 = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in ("poseidon2_permute", "rescue_permute"):
        check(launches2[name] > 0, f"{name} was not launched on the Poseidon2/Rescue path")
        launches[name] = launches2[name]
    say("launches", "Poseidon2/Rescue path: " + json.dumps(launches2))

    for cfg in (p2_bls, p2_bb):
        name = cfg.field.name
        check(p2_out[name].shape == p2_states[name].shape, f"Poseidon2 {name}: output shape")
        check_lanes_vs_oracle(cfg, p2_states[name], p2_out[name], main_sample, f"Poseidon2 {name} B=2^20")
        say("main", f"batched_permute Poseidon2 {name} t={cfg.t} at B=2^20 (kernel 3): 64 lanes == oracle")
    check_merkle(p2_bls, p2_leaves, p2_root, "Poseidon2")
    check(r_out.shape == r_state.shape, "Rescue: output shape")
    check_lanes_vs_oracle(r_bls, r_state, r_out, main_sample[::2], "Rescue B=2^20")
    say("main", f"batched_permute Rescue-Prime {fs.name} rate 2 at B=2^20 (kernel 5): 32 lanes == oracle")
    r_vals = [mont_tensor_to_ints(fs, r_lane_vals[i]) for i in range(2)]
    for b in list(range(4)) + [B_CHECK // 3, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
        o = st.OracleRescueSponge(r_bls)
        o.absorb(b"rescue transcript")
        o.absorb([st.Fp(5, fs), st.Fp(fs.modulus - 2, fs), st.Fp(0, fs)])
        o.absorb_field_elements([r_vals[0][b], r_vals[1][b]])
        check(r_squeezed[b] == o.squeeze_native_field_elements(3), f"Rescue sponge lane {b}: native squeeze")
        check(r_bytes[b] == o.squeeze_bytes(50), f"Rescue sponge lane {b}: squeeze_bytes")
        check(r_bits[b] == o.squeeze_bits(260), f"Rescue sponge lane {b}: squeeze_bits")
    say("sponge", f"lazy Rescue-Prime sponge B={B_CHECK}: native/bytes/bits squeezes == oracle on 8 lanes")

    # ---- 6. the GMiMC, Griffin and Anemoi path (kernels 8, 6 and 7), launches counted ----
    fam_cfgs = (m_bls, g_bls, a_bls, m_gl, g_gl, a_gl)
    fam_states = {
        id(cfg): with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
        for cfg in fam_cfgs
    }
    g_leaves = random_plane(gl, (gl.nlimbs, B_LADDER_PLAIN), rng, dev)
    m_lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    fam_out = {id(cfg): st.batched_permute(cfg, fam_states[id(cfg)]) for cfg in fam_cfgs}
    m_sponge = st.LazyPoseidonSponge(m_bls, batch_size=B_CHECK, device=dev)
    m_sponge.absorb(b"gmimc transcript")
    m_sponge.absorb([st.Fp(3, fs), st.Fp(fs.modulus - 1, fs)])
    m_sponge.absorb_element_plane(m_lane_vals)
    m_squeezed = m_sponge.squeeze_native_field_elements(3)
    m_bytes = m_sponge.squeeze_bytes(45)
    m_bits = m_sponge.squeeze_bits(270)
    g_root = merkle_root(g_gl, g_leaves)
    torch.cuda.synchronize()
    launches3 = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in ("gmimc_permute", "griffin_permute", "anemoi_permute"):
        check(launches3[name] > 0, f"{name} was not launched on the GMiMC/Griffin/Anemoi path")
        launches[name] = launches3[name]
    say("launches", "GMiMC/Griffin/Anemoi path: " + json.dumps(launches3))

    for cfg, family in zip(fam_cfgs, ("GMiMC", "Griffin", "Anemoi") * 2):
        what = f"{family} {cfg.field.name} t={cfg.t}"
        check(fam_out[id(cfg)].shape == fam_states[id(cfg)].shape, f"{what}: output shape")
        check_lanes_vs_oracle(cfg, fam_states[id(cfg)], fam_out[id(cfg)], main_sample[::2], f"{what} B=2^20")
        say("main", f"batched_permute {what} at B=2^20: 32 lanes == oracle")
    m_vals = [mont_tensor_to_ints(fs, m_lane_vals[i]) for i in range(2)]
    for b in list(range(4)) + [B_CHECK // 5, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
        o = st.OracleGmimcSponge(m_bls)
        o.absorb(b"gmimc transcript")
        o.absorb([st.Fp(3, fs), st.Fp(fs.modulus - 1, fs)])
        o.absorb_field_elements([m_vals[0][b], m_vals[1][b]])
        check(m_squeezed[b] == o.squeeze_native_field_elements(3), f"GMiMC sponge lane {b}: native squeeze")
        check(m_bytes[b] == o.squeeze_bytes(45), f"GMiMC sponge lane {b}: squeeze_bytes")
        check(m_bits[b] == o.squeeze_bits(270), f"GMiMC sponge lane {b}: squeeze_bits")
    say("sponge", f"lazy GMiMC sponge B={B_CHECK}: native/bytes/bits squeezes == oracle on 8 lanes")
    check_merkle(g_gl, g_leaves, g_root, "Griffin")

    # ---- 7. timing at the paths' shapes, beside each kernel's bound; the plain
    # version's timed run is on the path's own input lanes and must equal the
    # path's output there ----
    def time_kernel(name, cfg, big, lanes, path_out=None):
        k = kernels[name]
        consts = k["perm"](cfg, dev).consts
        small = big[..., lanes]
        ms, _ = time_ms(lambda: k["wrapper"](cfg, consts, big))
        # a launch-bound plain ladder: one warm call and one timed
        reps = 1 if id(cfg) in ladder_plain else 3
        plain_ms, plain_out = time_ms(lambda: k["plain"](cfg, consts, small), reps)
        n = small.shape[-1]
        if path_out is not None:
            check(
                torch.equal(path_out[..., lanes], plain_out),
                f"{name} {cfg.field.name}: the path's output at B={big.shape[-1]} != plain on {n} lanes",
            )
            say("main", f"{name} {cfg.field.name} t={cfg.t}: path output at B={big.shape[-1]} "
                f"== plain on {n} lanes")
        out = dict(ms=ms, plain_ms=plain_ms, plain_batch=n)
        out["bound_ms"], out["bound_by"] = bound(name, cfg, big.shape[-1], sm_clock_hz)
        say(
            "time",
            f"{name} {cfg.field.name} t={cfg.t} B={big.shape[-1]}: kernel {ms:.3f} ms = "
            f"{big.shape[-1] / ms * 1e3:,.0f} perms/s; bound {out['bound_ms']:.3f} ms "
            f"({out['bound_by']}, {limb_products(name, cfg):,} limb products per "
            f"permutation); plain torch {plain_ms:.1f} ms at B={n} = "
            f"{n / plain_ms * 1e3:,.0f} perms/s [{gpu}]",
        )
        return out

    every = slice(None)
    half = B_LADDER_PLAIN // 2  # the ladder families' plain lanes: both ends of the 2^20 plane
    ends = torch.cat([torch.arange(half), torch.arange(B_MAIN - half, B_MAIN)]).to(dev)
    kernels["poseidon_permute_opt"].update(time_kernel("poseidon_permute_opt", bls, state, every, out))
    kernels["poseidon_permute_dense"].update(time_kernel("poseidon_permute_dense", bls, state, every, parity))
    for cfg in (p2_bls, p2_bb):
        name = cfg.field.name
        timed = time_kernel("poseidon2_permute", cfg, p2_states[name], every, p2_out[name])
        if cfg is p2_bls:  # BabyBear t = 16 is the path's other width, not in the summary line
            kernels["poseidon2_permute"].update(timed)
    kernels["rescue_permute"].update(time_kernel("rescue_permute", r_bls, r_state, ends, r_out))
    time_kernel("rescue_permute", r_bb, p2_states[p2_bb.field.name], slice(0, B_CHECK))
    for name, cfg, lanes in (("gmimc_permute", m_bls, every), ("griffin_permute", g_bls, ends),
                             ("anemoi_permute", a_bls, ends)):
        kernels[name].update(time_kernel(name, cfg, fam_states[id(cfg)], lanes, fam_out[id(cfg)]))
    for name, cfg in (("gmimc_permute", m_gl), ("griffin_permute", g_gl), ("anemoi_permute", a_gl)):
        time_kernel(name, cfg, fam_states[id(cfg)], every, fam_out[id(cfg)])  # the path's other width

    summary = [
        {
            "name": name,
            "route": "cuda",
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "plain_batch": k["plain_batch"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a permutation
        }
        for name, k in kernels.items()
    ]
    print(json.dumps({"kernels": summary}))
    print(gpu)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def check_merkle(cfg, leaves, root, family):
    """The root of all ``leaves`` through the kernel equals the plain
    version's; a 2^10-leaf root equals the oracle's."""
    from sponge_tpu_torch.fields import mont_tensor_to_ints
    from sponge_tpu_torch.hash import merkle_root

    fs = cfg.field
    plain_root = merkle_root(cfg, leaves, backend="plain")
    n = f"2^{leaves.shape[-1].bit_length() - 1}"
    check(torch.equal(root, plain_root), f"{family} Merkle root over {n} leaves: kernel != plain")
    small = leaves[:, :1024]
    level = mont_tensor_to_ints(fs, small)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = oracle_for(cfg)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    check(mont_tensor_to_ints(fs, merkle_root(cfg, small)[:, None]) == level, f"{family} 2^10 Merkle root != oracle")
    say("merkle", f"{family} {fs.name} root over {n} leaves: kernel == plain; root over 2^10 leaves == oracle")


if __name__ == "__main__":
    sys.exit(main())
