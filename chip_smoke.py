"""On-card smoke test of the PyTorch/CUDA port (sponge_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from sponge_tpu_torch/csrc with nvcc (one nvcc
per source, in parallel): Poseidon (kernels 1 and 2), Poseidon2 (kernel 3),
Monolith (kernel 4), Rescue-Prime (kernel 5), Griffin-pi (kernel 6), Anemoi
(kernel 7), GMiMC-erf (kernel 8) and the two probe kernels.  It first runs
the probes (launches counted): the dependent latency and the saturated issue
rate of 32-bit and widening multiply-adds against their peaks, their SASS
instruction counts, one chain of 64 Montgomery products against two of 32,
and kernel 1's schedule cut to nested prefixes, each timed run's words
against the plain version on lanes from both ends.
It holds each kernel against its plain PyTorch version (torch.equal, with 0,
1, p-1, p-2 in every element position) and the scalar oracle, checks the
golden vectors through the sponge on the card, drives four paths at full
size with the launch counters zeroed just before each and read just after
(Poseidon: the batched BLS12-381 Fr rate-2 permutation at B = 2^20, the lazy
sponge, a 2^20-leaf Merkle root; Poseidon2 and Rescue: the BLS12-381 and
BabyBear permutations at B = 2^20, a 2^20-leaf Poseidon2 Merkle root, a lazy
Rescue sponge; GMiMC, Griffin and Anemoi: the BLS12-381 and Goldilocks
permutations at B = 2^20, a lazy GMiMC sponge, a 2^14-leaf Griffin Merkle
root; Monolith: the Goldilocks t = 12 and Mersenne31 t = 16 permutations at
B = 2^20, a lazy Monolith-31 sponge, a 2^20-leaf wide-digest Goldilocks
Merkle tree with 2^14 proofs opened and verified, a narrow BLS12-381 tree
with one proof), and times each kernel beside its plain version with CUDA
events.  The plain version's timed run takes the path's own 2^20-lane input
(for the BLS12-381 inverse-S-box families, Rescue, Griffin and Anemoi, 2^14
lanes from both ends of it) and must equal the path's output there.  Each
kernel's bound is the larger of the limb products the function needs
(``limb_products``: widening and 32-bit multiply-adds) over the card's
integer peaks and its state bytes over the memory rate.  Each phase prints
one line; any failure raises and exits non-zero.  Before the last line come a JSON summary
of the kernels and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.  It imports nothing of JAX or sponge_tpu.
"""

from __future__ import annotations

import functools
import json
import pathlib
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

# H100: 132 SMs, 3.35 TB/s of HBM3.  The bound's integer peaks, per clock
# per SM at the maximum SM clock: 64 32-bit multiply-adds (IMAD; the CUDA C++
# Programming Guide's arithmetic instruction throughput for compute
# capability 9.0) and 32 widening 32 x 32 -> 64-bit ones (IMAD.WIDE.U32
# issues as two IMADs: the probe phase reads half the IMAD rate for it, and
# checks that no reading passes its peak).  The bound with both kinds at 64
# is printed beside for comparison.
SMS, IMAD_PER_CLOCK, WIDE_PER_CLOCK, HBM_BYTES_PER_S = 132, 64, 32, 3.35e12
LATENCY_ITERS = 2048  # loop iterations of the one-chain latency runs (x 16 steps)
PROBE_MUL, PROBE_ADD = 0xF00DBEEF, 0x1234567  # odd, above 2^31: products in [2^31, 2^32) and above 2^47


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


def time_ms(fn, reps=3, warm=True):
    """(CUDA-event time of fn(): one warm call unless not ``warm``, then the
    best of ``reps``; the last call's result)."""
    if warm:
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


def monolith_plan_text(plan):
    """Kernel 4's plan (``ops/bounds.py`` ``MonolithPlan``)."""
    shift = f", R mod p = 2^{plan.shift}" if plan.shift is not None else ""
    return f"{plan.body} body, {plan.concrete} Concrete, folds (sq, add, conc, rc) {plan.folds}{shift}"


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
    """(wide, narrow): the integer multiplies one permutation needs on limbs
    (the bound's work, not any kernel's schedule).  Wide ones are
    32 x 32 -> 64-bit multiply-adds (IMAD.WIDE.U32: every Montgomery
    column), narrow ones 32-bit (IMAD: small-integer scalings of limb words
    and rho-folds, each c * rho_k below 2^32).  A Montgomery product is
    2 L^2 limb products (a * b and the REDC's q * p), a REDC alone (a
    product by plain 1) L^2 + L, a squaring L (L + 1) / 2 + L^2, a lazily
    summed row dot (t + 1) L^2; each power x^e
    takes its cheapest window chain (``chain_products``).  Poseidon2's and
    Griffin's small-integer matrix entries and scalings are one narrow
    product per limb, and Poseidon2 takes only the rho-folds its values
    need (``P2Plan.min_folds``), L each.  Monolith's generic body: per
    barred element per round a REDC out of Montgomery form and a product by
    R^2 back, t-1 squarings per
    round, t^2 L wide scalings per scaled Concrete (the entry times a limb
    word, summed in 64-bit columns) and L per fold of its high part, or t
    lazily summed rows per dense Concrete, L narrow products per 32-bit fold
    the plan takes, and the exit; its Mersenne body keeps one canonical word
    per element, so a squaring or a matrix entry is one wide product."""
    from sponge_tpu_torch.ops.bounds import (
        check_anemoi_bounds,
        check_griffin_bounds,
        check_monolith_bounds,
        p2_plan,
    )

    t, L = cfg.t, cfg.field.nlimbs
    mm, sq, row, redc = 2 * L * L, L * (L + 1) // 2 + L * L, (t + 1) * L * L, L * L + L
    if name == "monolith_permute":
        plan, R, u = check_monolith_bounds(cfg), cfg.rounds, cfg.bars
        if plan.body == "mersenne":
            return R * (t - 1) + (R + 1) * t * t, 0
        f_sq, f_add, f_conc, f_rc = plan.folds
        scaled = plan.concrete == "scaled"
        conc = t * t * L + t * f_conc * L if scaled else t * row
        wide = (R + 1) * conc + R * (u * (redc + mm) + (t - 1) * sq) + t * mm
        narrow = R * ((t - 1) * (f_sq + f_add) + t * f_rc) * L + (0 if scaled else (R + 1) * t * f_conc * L)
        return wide, narrow
    sb = chain_products(cfg.alpha, sq, mm)
    if name in ("poseidon_permute_opt", "poseidon_permute_dense"):
        full = cfg.full_rounds * (t * sb + t * row)
        if name == "poseidon_permute_dense":
            return full + cfg.partial_rounds * (sb + t * row), 0
        sparse = (cfg.partial_rounds - 1) * (row + (t - 1) * mm + sb)
        return full + sb + sparse + t * row, 0
    if name == "poseidon2_permute":
        wide = cfg.full_rounds * t * sb + cfg.partial_rounds * (sb + (0 if cfg.small_diag else t * mm)) + t * mm
        narrow = (cfg.full_rounds + 1) * t * t * L + (cfg.partial_rounds * t * L if cfg.small_diag else 0)
        return wide, narrow + p2_plan(cfg).min_folds * L
    if name == "rescue_permute":
        per_round = t * (sb + chain_products(cfg.inv_alpha, sq, mm)) + 2 * t * row
        return cfg.rounds * per_round + t * mm, 0
    if name == "gmimc_permute":  # the deferred adds are not products
        return cfg.rounds * sb + t * mm, 0
    if name == "griffin_permute":
        # gates: (i-1) y0 scaled limb by limb (narrow), L_i^2, alpha_i L_i,
        # x_i quad; the post-linear reduction only where the plan needs it
        gates_wide = (t - 2) * (sq + 2 * mm)
        gates_narrow = (t - 3) * L
        linear_wide = t * mm if check_griffin_bounds(cfg).reduce else 0
        wide = (cfg.rounds + 1) * linear_wide + cfg.rounds * (
            chain_products(cfg.inv_alpha, sq, mm) + sb + gates_wide
        ) + t * mm
        return wide, (cfg.rounds + 1) * t * t * L + cfg.rounds * gates_narrow
    if name == "anemoi_permute":
        # per pair: y^2, g y^2, u^(1/alpha), v^2, g v^2 (subtractions are
        # additions); M_x rows lazily summed where l > 1; the post-PHT
        # reduction only where the plan needs it
        lc = cfg.l
        diffusion = (2 * lc * (lc + 1) * L * L if lc > 1 else 0) + (
            t * mm if check_anemoi_bounds(cfg).reduce else 0
        )
        per_round = lc * (2 * sq + 2 * mm + chain_products(cfg.inv_alpha, sq, mm)) + diffusion
        return cfg.rounds * per_round + diffusion + t * mm, 0
    raise ValueError(name)


def bound(work, state_bytes, rates):
    """(bound_ms, bound_by) of one call: ``work`` (wide, narrow) multiply-adds
    over ``rates`` {"wide", "narrow"} (per second; both on the same integer
    pipe, so their times add), against ``state_bytes`` over the memory
    rate."""
    ops_ms = (work[0] / rates["wide"] + work[1] / rates["narrow"]) * 1e3
    bytes_ms = state_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kernel_bound(name, cfg, batch, rates):
    """``bound`` of one permutation call at ``batch`` lanes: the state read
    once and written once."""
    wide, narrow = limb_products(name, cfg)
    return bound((wide * batch, narrow * batch), 2 * cfg.t * cfg.field.nlimbs * 4 * batch, rates)


def sass_counts(lib_path, function_key):
    """Opcode counts of the one function of ``lib_path`` whose mangled name
    holds ``function_key`` (cuobjdump -sass)."""
    from sponge_tpu_torch.ops import _build

    cuobjdump = str(pathlib.Path(_build._nvcc()).with_name("cuobjdump"))
    counts, inside = {}, False
    for line in run([cuobjdump, "-sass", str(lib_path)]).splitlines():
        if "Function :" in line:
            inside = function_key in line
        elif inside and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0][0].isupper():
                counts[words[0]] = counts.get(words[0], 0) + 1
    check(counts, f"no SASS for {function_key}")
    return counts


def probe_phase(st, dev, rng, gpu, peak):
    """The probe kernels, launches counted: dependent latencies, saturated
    rates against the ``peak`` rates every bound divides by, SASS counts,
    one against two Montgomery chains, and the ablation of kernel 1.  Every
    timed run's output equals the plain version at the same chains and
    steps on lanes from both ends of its plane (uint32_probe's semantics
    check).  Returns the two probes' summary entries."""
    from sponge_tpu_torch.ops import _build, probe
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt
    from sponge_tpu_torch.poseidon.permutation import permutation_for

    probe.probe_chains.launches = probe.probe_ablation.launches = 0

    def chain_input(op, chains, B):
        if op == "mont11":
            fs = st.BLS12_381_FR
            return random_plane(fs, (chains, fs.nlimbs, B), rng, dev)
        words = rng.integers(-(2**31), 2**31, size=(chains, probe.WORDS[op], B))
        return torch.from_numpy(words.astype(np.int32)).to(dev)

    def chain_consts(op):
        mul = 0x1234567890ABCDEF if op == "mont11" else PROBE_MUL
        return torch.from_numpy(probe.chain_constants(op, mul, PROBE_ADD)).to(dev)

    def ends(B, n):
        return torch.cat([torch.arange(n // 2), torch.arange(B - n // 2, B)]).to(dev)

    err = {"chains": 0, "ablation": 0}
    ranges = {"mul": 0, "wide": 0}  # first products in [2^31, 2^32); widening products above 2^47

    def held(op, consts, x, iters, out, lanes=1024):
        """``out`` == the plain chains on ``lanes`` lanes from both ends of
        ``x``; the plain version's CUDA-event ms (one call)."""
        sel = ends(x.shape[-1], min(lanes, x.shape[-1]))
        xs = x[..., sel].contiguous()
        plain_ms, want = time_ms(lambda: probe.chains_plain(op, consts, xs, iters), reps=1, warm=False)
        got = out[..., sel]
        err["chains"] = max(err["chains"], int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"probe chains {op} x{x.shape[0]} at B={x.shape[-1]}, {iters} "
              f"iterations: kernel != plain on {sel.numel()} lanes")
        if op in ranges:
            a = xs[:, -1].cpu().numpy().astype(np.int64) & 0xFFFFFFFF  # mul: the word; wide: the high word
            ranges[op] += int(((a * PROBE_MUL) % 2**32 >= 2**31).sum() if op == "mul" else (a * PROBE_MUL >= 2**47).sum())
        return plain_ms

    # 1. dependent latency: one chain, one block; 2. issue rate: 4-16 chains at B = 2^20
    clocks = torch.zeros(2, dtype=torch.int64, device=dev)
    chains_entry, timed = None, {}
    for op in ("mul", "mad", "add", "wide"):
        consts = chain_consts(op)
        x = chain_input(op, 1, 128)
        _, out = time_ms(lambda: probe.probe_chains(op, consts, x, LATENCY_ITERS, clocks))
        cycles, _ = clocks.tolist()
        latency = cycles / probe.chain_steps(op, LATENCY_ITERS)
        held(op, consts, x, LATENCY_ITERS, out, 128)
        best = None
        for chains in (4, 8, 16):
            x = chain_input(op, chains, B_MAIN)
            ms, out = time_ms(lambda: probe.probe_chains(op, consts, x, 128, clocks))
            cycles, ns = clocks.tolist()
            plain_ms = held(op, consts, x, 128, out)
            ops = B_MAIN * chains * probe.chain_steps(op, 128)
            if best is None or ops / ms > best[0]:
                best = (ops / ms, ms, chains, ops, cycles / ns * 1e9, x, plain_ms)
        per_s, ms, chains, ops, clock_hz, x, plain_ms = best
        timed[op] = (ms, plain_ms)
        reading = f"{per_s * 1e3 / (SMS * clock_hz):.2f} per clock per SM at the run's SM clock {clock_hz / 1e6:.0f} MHz"
        peak_text = ""
        if op != "add":  # the bounds count multiply-adds only
            kind = "wide" if op == "wide" else "narrow"
            bound_ms, bound_by = bound((ops, 0) if kind == "wide" else (0, ops), 2 * x.numel() * 4, peak)
            check(per_s * 1e3 <= peak[kind], f"{op}: {reading}, above the bound's peak")
            peak_text = (f"; peak {WIDE_PER_CLOCK if kind == 'wide' else IMAD_PER_CLOCK} per clock per SM at the "
                         f"max SM clock: bound {bound_ms:.3f} ms, {bound_ms / ms:.1%} of it")
        say("probe", f"{op}: dependent latency {latency:.2f} cycles; saturated {per_s * 1e3:.4e}/s at {chains} "
            f"chains x 2^20 lanes x {probe.chain_steps(op, 128)} steps ({ms:.3f} ms) = {reading}{peak_text}; "
            f"plain {plain_ms:.1f} ms at 1024 lanes, same chains and steps [{gpu}]")
        if op == "wide":
            chains_entry = dict(ms=ms, plain_ms=plain_ms, plain_batch=1024, bound_ms=bound_ms, bound_by=bound_by)
    check(ranges["mul"] > 0 and ranges["wide"] > 0, "the probe inputs missed the product ranges")
    say("probe", f"chain words == plain on every run above (1-16 chains; {ranges['mul']} first products in "
        f"[2^31, 2^32), {ranges['wide']} widening products above 2^47 among the compared lanes)")

    # 3. one chain of 64 Montgomery products against two of 32 (latency_probe)
    consts = chain_consts("mont11")
    dep, ind = chain_input("mont11", 1, B_MAIN), chain_input("mont11", 2, B_MAIN)
    dep_ms, dep_out = time_ms(lambda: probe.probe_chains("mont11", consts, dep, 64))
    ind_ms, ind_out = time_ms(lambda: probe.probe_chains("mont11", consts, ind, 32))
    dep_plain = held("mont11", consts, dep, 64, dep_out)
    ind_plain = held("mont11", consts, ind, 32, ind_out)
    mont_ms, _ = bound((64 * 2 * 11**2 * B_MAIN, 0), 2 * dep.numel() * 4, peak)
    say("probe", f"mont11 at B=2^20: one chain of 64 products {dep_ms:.3f} ms, two of 32 {ind_ms:.3f} ms "
        f"(ratio {ind_ms / dep_ms:.3f}: ~1 throughput-bound, ~0.5 latency-bound); bound {mont_ms:.3f} ms at the "
        f"widening peak; == plain on 1024 lanes ({dep_plain:.1f}, {ind_plain:.1f} ms) [{gpu}]")

    # 4. SASS: one instruction per step?
    lib = _build.library_path()
    for op, key, opcode in (("wide", "chains_kernelILi3ELi16E", "IMAD.WIDE.U32"), ("mul", "chains_kernelILi0ELi16E", "IMAD")):
        counts = sass_counts(lib, key)
        steps = probe.UNROLL * 16
        say("sass", f"{op} chains x16: {counts.get(opcode, 0)} {opcode} for {steps} steps per loop body "
            f"(+ the rest: {sorted((k, v) for k, v in counts.items() if k != opcode and v > 4)})")
        check(counts.get(opcode, 0) >= steps, f"{op}: fewer {opcode} than steps in the SASS")

    # 5. kernel 1's schedule cut to nested prefixes (latency_accounting_probe)
    bls = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    fs = bls.field
    consts = torch.from_numpy(probe.ablation_constants(bls)).to(dev)
    big = random_plane(fs, (bls.t, fs.nlimbs, B_MAIN), rng, dev)
    sel = ends(B_MAIN, 2048)
    small = big[..., sel].contiguous()
    rows, plain_rows = {}, {}
    for mode in probe.ABLATION_MODES:
        rows[mode], out = time_ms(lambda: probe.probe_ablation(bls, mode, consts, big))
        plain_rows[mode], want = time_ms(lambda: probe.ablation_plain(bls, mode, consts, small), reps=1, warm=False)
        err["ablation"] = max(err["ablation"], int((out[..., sel].long() - want.long()).abs().max()))
        check(torch.equal(out[..., sel], want), f"ablation {mode} at B=2^20: kernel != plain on 2048 lanes")
    kernel1 = permutation_for(bls, dev).consts
    rows["full"] = time_ms(lambda: permute_opt(bls, kernel1, big))[0]
    say("probe", "kernel 1 ablation at B=2^20, each prefix == plain on 2048 lanes from both ends: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in rows.items())
        + f"; so grid and HBM {rows['copy']:.3f}, ark+carry {rows['ark'] - rows['copy']:.3f}, S-boxes "
        f"{rows['pow'] - rows['ark']:.3f}, MDS and the rest {rows['full'] - rows['pow']:.3f} ms; plain "
        + ", ".join(f"{k} {v:.1f}" for k, v in plain_rows.items()) + f" ms at 2048 lanes [{gpu}]")
    mm = 2 * fs.nlimbs ** 2
    sb = chain_products(bls.alpha, fs.nlimbs * (fs.nlimbs + 1) // 2 + fs.nlimbs ** 2, mm)
    work = (bls.full_rounds * bls.t + bls.partial_rounds) * sb + bls.t * mm
    torch.cuda.synchronize()
    launches = {"probe_chains": probe.probe_chains.launches, "probe_ablation": probe.probe_ablation.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched in the probe phase")
    say("launches", "probe phase: " + json.dumps(launches))
    ablation_entry = dict(ms=rows["pow"], plain_ms=plain_rows["pow"], plain_batch=small.shape[-1])
    ablation_entry["bound_ms"], ablation_entry["bound_by"] = bound((work * B_MAIN, 0), 2 * big.numel() * 4, peak)
    return {
        "probe_chains": dict(source="sponge_tpu_torch/csrc/probe.cu", replaces="bench/vpu_roofline_probe.py:96",
                             launches=launches["probe_chains"], max_abs_err=err["chains"], **chains_entry),
        "probe_ablation": dict(source="sponge_tpu_torch/csrc/probe.cu",
                               replaces="bench/latency_accounting_probe.py:43",
                               launches=launches["probe_ablation"], max_abs_err=err["ablation"], **ablation_entry),
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2

    import sponge_tpu_torch as st
    from sponge_tpu_torch.fields import mont_tensor_to_ints
    from sponge_tpu_torch.hash import (
        compress_pairs,
        default_digest_elems,
        merkle_open,
        merkle_open_batch_wide,
        merkle_root,
        merkle_tree,
        merkle_tree_wide,
        merkle_verify,
        merkle_verify_batch_wide,
    )
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.monolith import monolith_permute, monolith_permute_plain
    from sponge_tpu_torch.ops.anemoi import anemoi_permute, anemoi_permute_plain
    from sponge_tpu_torch.ops.bounds import (
        check_anemoi_bounds,
        check_gmimc_bounds,
        check_griffin_bounds,
        check_kernel_bounds,
        check_monolith_bounds,
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

    # ---- 2. the probes: the integer rates every bound below rests on ----
    rates = {"wide": SMS * WIDE_PER_CLOCK * sm_clock_hz, "narrow": SMS * IMAD_PER_CLOCK * sm_clock_hz}
    probe_entries = probe_phase(st, dev, rng, gpu, rates)
    flat_rates = {k: SMS * IMAD_PER_CLOCK * sm_clock_hz for k in ("wide", "narrow")}

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
    mo_gl = st.get_default_monolith_parameters(gl)
    mo_gl8 = st.get_default_monolith_parameters(gl, 4)
    mo_m31 = st.get_default_monolith_parameters(st.MERSENNE31_FR)
    mo_kb = st.get_default_monolith_parameters(st.KOALABEAR_FR)
    mo_bb = st.get_default_monolith_parameters(st.BABYBEAR_FR)
    mo_kb4 = st.generate_monolith_parameters(st.KOALABEAR_FR, 2, 2, 6, 2)
    mo_m314 = st.generate_monolith_parameters(st.MERSENNE31_FR, 2, 2, 6, 2)

    # ---- 3. golden vectors through the sponge on the card ----
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
        ("Monolith", mo_gl, list(range(8)), 3,
         [5256865702680375205, 16889867171626752680, 17825305887195455664]),
        ("Monolith", mo_m31, list(range(8)), 3, [1207749644, 841790736, 175126303]),
        ("Monolith", mo_gl8, [0, 1, 2, 3], 2, [3013020673448842056, 17604359482555244088]),
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

    # ---- 4. each kernel against its plain version ----
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
        "monolith_permute": dict(
            wrapper=monolith_permute, plain=monolith_permute_plain,
            perm=functools.partial(family_permutation_for, st.MonolithPermutation),
            bound=lambda cfg: monolith_plan_text(check_monolith_bounds(cfg)),
            configs=[mo_gl, mo_gl8, mo_m31, mo_kb, mo_bb, mo_kb4, mo_m314],
            source="sponge_tpu_torch/csrc/monolith.cu",
            replaces="sponge_tpu/ops/pallas_monolith.py:722",
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
            before = k["wrapper"].launches
            out_k = k["wrapper"](cfg, perm.consts, state)
            torch.cuda.synchronize()
            check(k["wrapper"].launches == before + 1, f"{name}: the kernel was not launched")
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

    # ---- 5. the Poseidon path (kernels 1 and 2), launches counted ----
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

    # ---- 6. the Poseidon2 and Rescue-Prime path (kernels 3 and 5), launches counted ----
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

    # ---- 7. the GMiMC, Griffin and Anemoi path (kernels 8, 6 and 7), launches counted ----
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

    # ---- 8. the Monolith path (kernel 4) with the Merkle API, launches counted ----
    mo_states = {
        id(cfg): with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
        for cfg in (mo_gl, mo_m31)
    }
    m31 = mo_m31.field
    d = default_digest_elems(mo_gl)
    wide_leaves = random_plane(gl, (d, gl.nlimbs, B_MAIN), rng, dev)
    proof_idx = torch.from_numpy(np.concatenate([[0, B_MAIN - 1], rng.choice(B_MAIN, (1 << 14) - 2, replace=False)]))
    mo_lane_vals = random_plane(m31, (3, m31.nlimbs, B_CHECK), rng, dev)
    narrow_leaves = random_plane(fs, (fs.nlimbs, 1 << 14), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    mo_out = {id(cfg): st.batched_permute(cfg, mo_states[id(cfg)]) for cfg in (mo_gl, mo_m31)}
    mo_sponge = st.LazyPoseidonSponge(mo_m31, batch_size=B_CHECK, device=dev)
    mo_sponge.absorb(b"monolith transcript")
    mo_sponge.absorb([st.Fp(m31.modulus - 1, m31), st.Fp(0, m31), st.Fp(1, m31)])
    mo_sponge.absorb_element_plane(mo_lane_vals)
    mo_squeezed = mo_sponge.squeeze_native_field_elements(11)
    mo_bytes = mo_sponge.squeeze_bytes(70)
    mo_bits = mo_sponge.squeeze_bits(300)
    levels = merkle_tree_wide(mo_gl, wide_leaves)
    paths = merkle_open_batch_wide(levels, proof_idx)
    verified = merkle_verify_batch_wide(mo_gl, levels[-1][..., 0], wide_leaves[..., proof_idx.to(dev)], paths, proof_idx)
    tampered = paths.clone()
    tampered[7, :, :, 5] = wide_leaves[:, :, 0]  # a canonical digest that is not this lane's sibling
    refused = merkle_verify_batch_wide(mo_gl, levels[-1][..., 0], wide_leaves[..., proof_idx.to(dev)], tampered, proof_idx)
    narrow_levels = merkle_tree(bls, narrow_leaves)
    narrow_path = merkle_open(narrow_levels, 12345)
    narrow_ok = merkle_verify(bls, narrow_levels[-1][:, 0], narrow_leaves[:, 12345], narrow_path, 12345)
    narrow_bad = merkle_verify(bls, narrow_levels[-1][:, 0], narrow_leaves[:, 12346], narrow_path, 12345)
    torch.cuda.synchronize()
    launches4 = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in ("monolith_permute", "poseidon_permute_opt"):
        check(launches4[name] > 0, f"{name} was not launched on the Monolith path")
    launches["monolith_permute"] = launches4["monolith_permute"]
    say("launches", "Monolith path: " + json.dumps(launches4))

    for cfg in (mo_gl, mo_m31):
        what = f"Monolith {cfg.field.name} t={cfg.t} ({check_monolith_bounds(cfg).body} body)"
        check(mo_out[id(cfg)].shape == mo_states[id(cfg)].shape, f"{what}: output shape")
        check_lanes_vs_oracle(cfg, mo_states[id(cfg)], mo_out[id(cfg)], main_sample, f"{what} B=2^20")
        say("main", f"batched_permute {what} at B=2^20: 64 lanes == oracle")
    mo_vals = [mont_tensor_to_ints(m31, mo_lane_vals[i]) for i in range(3)]
    for b in list(range(4)) + [B_CHECK // 7, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
        o = st.OracleMonolithSponge(mo_m31)
        o.absorb(b"monolith transcript")
        o.absorb([st.Fp(m31.modulus - 1, m31), st.Fp(0, m31), st.Fp(1, m31)])
        o.absorb_field_elements([mo_vals[i][b] for i in range(3)])
        check(mo_squeezed[b] == o.squeeze_native_field_elements(11), f"Monolith sponge lane {b}: native squeeze")
        check(mo_bytes[b] == o.squeeze_bytes(70), f"Monolith sponge lane {b}: squeeze_bytes")
        check(mo_bits[b] == o.squeeze_bits(300), f"Monolith sponge lane {b}: squeeze_bits")
    say("sponge", f"lazy Monolith-31 sponge B={B_CHECK}: native/bytes/bits squeezes == oracle on 8 lanes")
    check_merkle_wide(mo_gl, wide_leaves, levels[-1][..., 0])
    check(bool(verified.all()), f"wide proofs: {int((~verified).sum())} of {verified.numel()} failed")
    check(not bool(refused[5]) and bool(refused[:5].all()) and bool(refused[6:].all()),
          "a tampered wide proof: only its own lane must fail")
    say("merkle", f"merkle_open_batch_wide + merkle_verify_batch_wide: {verified.numel()} proofs (leaves 0 and "
        f"2^20-1 among them) verify; one tampered sibling fails its lane only")
    check(narrow_ok and not narrow_bad, "narrow merkle_verify")
    check(len(narrow_path) == 14 and torch.equal(merkle_root(bls, narrow_leaves), narrow_levels[-1][:, 0]),
          "narrow merkle_tree / merkle_root")
    say("merkle", f"narrow merkle_tree / merkle_open / merkle_verify over 2^14 {fs.name} Poseidon leaves: the "
        f"proof verifies, a wrong leaf fails")

    # ---- 9. timing at the paths' shapes, beside each kernel's bound; the plain
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
        out["bound_ms"], out["bound_by"] = kernel_bound(name, cfg, big.shape[-1], rates)
        flat_ms, _ = kernel_bound(name, cfg, big.shape[-1], flat_rates)
        wide, narrow = limb_products(name, cfg)
        say(
            "time",
            f"{name} {cfg.field.name} t={cfg.t} B={big.shape[-1]}: kernel {ms:.3f} ms = "
            f"{big.shape[-1] / ms * 1e3:,.0f} perms/s; bound {out['bound_ms']:.3f} ms "
            f"({out['bound_by']}, {wide:,} wide + {narrow:,} 32-bit limb products per permutation at the "
            f"peaks of {WIDE_PER_CLOCK} and {IMAD_PER_CLOCK} per clock per SM; {flat_ms:.3f} ms at "
            f"{IMAD_PER_CLOCK} for both); "
            f"plain torch {plain_ms:.1f} ms at B={n} = {n / plain_ms * 1e3:,.0f} perms/s [{gpu}]",
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
    kernels["monolith_permute"].update(time_kernel("monolith_permute", mo_gl, mo_states[id(mo_gl)], every,
                                                   mo_out[id(mo_gl)]))
    time_kernel("monolith_permute", mo_m31, mo_states[id(mo_m31)], every, mo_out[id(mo_m31)])

    for name, entry in probe_entries.items():
        kernels[name] = entry
        launches[name] = entry["launches"]
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
            "library_ms": None,  # no single PyTorch call computes a permutation or a probe chain
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


def check_merkle_wide(cfg, leaves, root):
    """The wide root of all ``leaves`` through the kernel equals the plain
    version's; a 2^10-leaf root equals the oracle's (each node: absorb the
    2d children's elements, squeeze d)."""
    from sponge_tpu_torch.fields import mont_tensor_to_ints
    from sponge_tpu_torch.hash import merkle_root_wide

    fs, d = cfg.field, leaves.shape[0]
    check(torch.equal(root, merkle_root_wide(cfg, leaves, backend="plain")), "wide Merkle root: kernel != plain")
    small = leaves[..., :1024]
    cols = mont_tensor_to_ints(fs, small)
    level = [[cols[e][i] for e in range(d)] for i in range(1024)]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = oracle_for(cfg)
            o.absorb_field_elements(level[i] + level[i + 1])
            nxt.append(o.squeeze_native_field_elements(d))
        level = nxt
    got = mont_tensor_to_ints(fs, merkle_root_wide(cfg, small)[..., None])
    check([v[0] for v in got] == level[0], "wide 2^10 Merkle root != oracle")
    n = f"2^{leaves.shape[-1].bit_length() - 1}"
    say("merkle", f"wide-digest (d = {d}) {fs.name} t={cfg.t} root over {n} leaves: kernel == plain; root over "
        f"2^10 leaves == oracle")


if __name__ == "__main__":
    sys.exit(main())
