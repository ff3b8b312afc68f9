"""On-card smoke test of the PyTorch/CUDA port (sponge_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from sponge_tpu_torch/csrc with nvcc (one nvcc
per source, in parallel): Poseidon (kernels 1 and 2), Poseidon2 (kernel 3),
Monolith (kernel 4), Rescue-Prime (kernel 5), Griffin-pi (kernel 6), Anemoi
(kernel 7), GMiMC-erf (kernel 8) and the two probe kernels, and prints the
window, table bytes, registers and spills of each instantiation of kernels
5, 6 and 7 (failing if the compiled registers would pick another window
than the shipped one) and kernel 3's registers and staged bytes per body,
and for kernels 1-4, 6 and 8 every instantiation's registers, spills
and blocks per SM and a static SASS census of the timed ones beside the
products the bound counts (kernels 2 and 8: each body, and the limb body at
Goldilocks).  It first runs
the probes (launches counted): the dependent latency and the saturated issue
rate of 32-bit and widening multiply-adds against their peaks, their SASS
instruction counts, one chain of 64 Montgomery products against two of 32,
and kernel 1's schedule cut to nested prefixes (copy, round constants,
S-boxes, the full rounds' MDS; kernel 1 adds the sparse phase), each timed
run's words against the plain version on lanes from both ends.
It holds each kernel against its plain PyTorch version (torch.equal, with 0,
1, p-1, p-2 in every element position) and the scalar oracle, checks the
golden vectors through the sponge on the card, drives four paths at full
size with the launch counters zeroed just before each and read just after
(Poseidon: the batched BLS12-381 Fr rate-2 permutation at B = 2^20, the lazy
sponge, a 2^20-leaf Merkle root; Poseidon2 and Rescue: the BLS12-381 and
BabyBear permutations and the KoalaBear Poseidon2 one at B = 2^20, a
2^20-leaf Poseidon2 Merkle root, a lazy Rescue sponge; kernel 3's overwrite
sponge at the MMCS cell's sizes: one commitment's row set, its launches
counted (the 2^23 x 64 BabyBear leaf set in one launch, its truncated
tree a launch a level), the digests and every level against the plain
backend on the card, the digests against the unfused loop, one level from
lane-stride-2 views against the ``cat``, both against the oracle on random
and near-bound lanes, the plain permutation at BabyBear and KoalaBear
t = 16 timed beside the kernel table (``--only poseidon2_overwrite`` runs
this phase alone); kernel 5's MDS-first order (Rescue Prime Optimized,
Miden's RPO256) at the Miden cell's sizes: the permutation at B = 2^20
against plain and the oracle, edge and near-bound lanes among them, one
commitment's row set (2^21 rows of 71 through ``rpo_hash_elements``, 9
launches, its merge tree a launch a level) against the plain backend on
every lane and the oracle's sponge, and kernel 5's Rescue-Prime rows timed
beside the kernel table (``--only rescue_rpo`` runs this phase alone);
kernel 1's tagged step at the Filecoin cell's size: an arity-8 tree with
neptune's tag 255 over 2^27 BLS12-381 leaves in 9 launches, sampled nodes
of every level (children all p-1 and all p-2 among them) against the plain
backend, the benchmark's reference and the oracle, the tree and a tagged
step timed, and the cell's control reading ``correct`` false
(``--only poseidon_octtree`` runs this phase alone);
GMiMC, Griffin and Anemoi: the BLS12-381 and Goldilocks permutations at
B = 2^20 (kernel 8's limb body at BLS12-381, its two-word
body at Goldilocks, each with near-bound lanes of p-1 and p-2 in every
element), a lazy GMiMC sponge, a 2^14-leaf Griffin Merkle
root; Monolith: the Goldilocks t = 12 and Mersenne31 t = 16 permutations at
B = 2^20, a lazy Monolith-31 sponge, a 2^20-leaf wide-digest Goldilocks
Merkle tree with 2^14 proofs opened and verified, a narrow BLS12-381 tree
with one proof; sharded, Jive and checkpoints, in a world-size-1 NCCL group:
the sharded permutation at B = 2^20 and transcript at 2^16 lanes, the
sharded Merkle root over 2^24 BLS12-381 leaves with 2^14 sharded proofs,
the sharded wide Monolith root, Jive-mode trees over 2^20 Anemoi t = 2
and Griffin Goldilocks t = 8 leaves with proofs and the sharded Jive
root, a Merkle level and a 2^16-lane sponge saved and resumed, the
parity-gated scaling report, a profiler trace of the sharded root with
the device's busy share, and the torchrun CLI in a subprocess; the host
runtime, the tracer and the examples: the native C++ host libraries must
build, the Fiat-Shamir example at 2^20 transcripts with 4,096 of them
verified by ``host_run_schedule``, the Merkle example at 2^20 Goldilocks
leaves with 2^14 proofs, the family tour, each tour config's permutation at
2^16 states against ``host_permute_states`` on every lane, and a random
lazy-sponge schedule whose lane the R1CS tracer reproduces, with the host
side's times beside the card's on ``[host]``/``[codec]`` lines; every
default Poseidon and Poseidon2 width: each of the 52 default Poseidon
configs through kernels 1 and 2 and the 14 Poseidon2 ones through kernel 3
at 2^14 lanes against the plain versions, the oracle and the host runtime,
one config per (t, L) beyond rate 2 timed at B = 2^20 beside its bound
with its census line, lazy and eager sponges at BLS12-381 t = 9 and
Goldilocks t = 12 and a Goldilocks transcript at 2^16 lanes; every default
Rescue-Prime, GMiMC, Griffin and Anemoi width: each of the 115 default
configs through kernels 5, 8, 6 and 7 at 2^12 lanes against the host
runtime on every lane and the oracle on 16, the first config of each of
the 44 (t, L) pairs compiled since the wide schedules == plain, each new
pair timed at B = 2^20 beside its bound with its census line, a lazy Rescue-Prime and an eager GMiMC sponge at BLS12-381 t = 9 (the
front reduction), a Griffin Goldilocks t = 12 Merkle root and an Anemoi
BLS12-381 t = 8 transcript at 2^16 lanes), and times
each kernel beside its plain version with CUDA
events (kernel 5 at BLS12-381 also with its inverse S-box at windows 3 and
4, in turns; kernel 8's limb body beside its two-word body at Goldilocks,
in turns).  The plain version's timed run takes the path's own 2^20-lane input
(for the BLS12-381 inverse-S-box families, Rescue, Griffin and Anemoi, 2^14
lanes from both ends of it) and must equal the path's output there.  Each
kernel's bound is the larger of the products the function needs
(``limb_products``: widening and 32-bit multiply-adds; one 32-bit word per
element at a field below 2^31 and two at Goldilocks, where the limb count's
bound is printed beside) over the
card's integer peaks and its state bytes over the memory rate.  Each phase prints
one line; any failure raises and exits non-zero.  Before the last line come a JSON summary
of the kernels and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.  ``--only NAME[,NAME]`` (names of its kernel table) runs
the build, the window and census lines and the named kernels' checks and
timings alone (with any of kernels 1, 2 and 3 named, the widths path
too; with any of kernels 5-8, the family widths path), to compare two trees
in one call.  It imports nothing of JAX or
sponge_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    the top limb below p's, so every value is below p.  Drawn on ``device``
    by a generator seeded from ``rng`` (a 2^20-lane plane at t = 9 took
    about 1.6 s through numpy on the host)."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 1 << 62)))
    limbs = torch.randint(0, 1 << 24, shape, generator=gen, device=device, dtype=torch.int32)
    top = fs.modulus >> (24 * (fs.nlimbs - 1))
    limbs[..., -1, :] = torch.randint(0, top, limbs[..., -1, :].shape, generator=gen, device=device,
                                      dtype=torch.int32)
    return limbs


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


NEAR_BOUND_LANES = (64, 65)


def with_maxima(fs, plane):
    """Put p-1 in every element of lane 64 and p-2 in every element of lane
    65 (``NEAR_BOUND_LANES``): kernel 8's largest inputs, with which every
    first-round add of the two-word body carries into its excess word."""
    plane = plane.clone()
    for b, v in zip(NEAR_BOUND_LANES, (fs.modulus - 1, fs.modulus - 2)):
        plane[:, :, b] = torch.from_numpy(fs.ints_to_mont_plane([v])[:, 0])[None]
    return plane


def lane_ints(fs, plane, b):
    return [fs.mont_plane_to_ints(plane[e, :, b : b + 1].cpu().numpy())[0] for e in range(plane.shape[0])]


def oracle_permute(cfg, vals):
    o = cfg.oracle_sponge()
    o.state = list(vals)
    o.permute()
    return o.state


def check_lanes_vs_oracle(cfg, state_in, state_out, lanes, what):
    for b in lanes:
        want = oracle_permute(cfg, lane_ints(cfg.field, state_in, b))
        check(lane_ints(cfg.field, state_out, b) == want, f"{what}: lane {b} differs from the oracle")


def call_kernel(k, cfg, perm, state):
    """Kernel ``k``'s wrapper on ``state`` with ``perm``'s buffers (kernels 1
    and 2 also read their word bodies' buffer, the attribute ``k["words"]``
    names: ``perm.opt_words``, ``perm.words``)."""
    return k["wrapper"](cfg, perm.consts, state, *((getattr(perm, k["words"]),) if k.get("words") else ()))


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


def p2_plan_text(cfg, plan):
    """Kernel 3's plan (``ops/bounds.py`` ``P2Plan``)."""
    if plan.body == "word":
        return (f"one-word body, {'structured' if plan.structured else 'dense'} M_E, largest row sum "
                f"{plan.vmax / cfg.field.modulus:.1f}p, largest word {plan.wmax / 2**32:.3f} x 2^32")
    rounds = sum(1 for pre, sbox in plan.folds[:-1] if pre or sbox)
    return (f"limb body, folds in {rounds} of {cfg.rounds} rounds (most {max(f[0] for f in plan.folds)} before "
            f"the S-boxes, {max(f[1] for f in plan.folds)} after each product), {plan.min_folds} folds a "
            f"permutation needs, largest value before a fold {plan.vmax / cfg.field.r:.1f}R, largest limb word "
            f"{plan.wmax / 2**24:.1f} x 2^24")


def gmimc_body(cfg):
    """Kernel 8's body for ``cfg`` (``ops/gmimc.py`` ``body``); "limb" in a
    tree from before the two-word body (a two-tree comparison's parent)."""
    from sponge_tpu_torch.ops import gmimc

    return gmimc.body(cfg) if hasattr(gmimc, "body") else "limb"


def gmimc_plan_text(cfg):
    """Kernel 8's body and its replay (``ops/bounds.py``
    ``check_gmimc_word_bounds`` for the two-word body, else
    ``check_gmimc_bounds``)."""
    from sponge_tpu_torch.ops import bounds

    if gmimc_body(cfg) == "word":
        return f"two-word body, largest excess word {bounds.check_gmimc_word_bounds(cfg)}"
    return "limb body, " + plan_text(cfg, bounds.check_gmimc_bounds(cfg))


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


def limb_products(name, cfg, words=True):
    """(wide, narrow): the integer multiplies one permutation needs (the
    bound's work, not any kernel's schedule).  Wide ones are 32 x 32 ->
    64-bit multiply-adds (IMAD.WIDE.U32: every Montgomery column), narrow
    ones 32-bit (IMAD: small-integer scalings of limb words, rho-folds and
    Montgomery quotients).  On limbs a Montgomery product is 2 L^2 limb
    products (a * b and the REDC's q * p), a REDC alone (a product by plain
    1) L^2 + L, a squaring L (L + 1) / 2 + L^2, a lazily summed row dot
    (t + 1) L^2; each power x^e takes its cheapest window chain
    (``chain_products``).  Poseidon2's and Griffin's small-integer matrix
    entries and scalings are one narrow product per limb, and Poseidon2
    takes only the rho-folds its values need (``P2Plan.min_folds``), L
    each.  With ``words`` (the default) an element is counted in the fewest
    32-bit words that hold it, whatever body a kernel runs, so the bound
    reads the same work for every body.  A field below 2^31 keeps one word
    per element: a Montgomery product or a squaring is 2 wide (a * b, q * p)
    and 1 narrow (q), a REDC or the reduction of a 64-bit sum 1 wide and 1
    narrow, a row dot t wide products and one REDC, a small-integer scaling
    one product (wide where the sum can pass 2^32), Poseidon2's M_E the fewer
    of its dense rows and, where the matrix is circ(2 M4, ..., M4), its
    addition chain's operations (narrow), plus a reduction per row, and the
    plane's R = 2^48 is converted to one word and back (2 t products).
    Goldilocks keeps two words per element in plain form: a product is 4
    wide (the 128-bit product from 32-bit halves), a squaring 3, a reduction
    mod p none (2^64 = 2^32 - 1 and 2^96 = -1: shifts and adds), a row dot n
    products of 4 and one reduction, a small-integer scaling 1 wide per word,
    each power its cheapest chain at those costs, and the plane's R = 2^72
    is converted to plain form and back (2 t products of 4); Monolith's
    REDC out of Montgomery form and product by R^2 back, and every fold or
    optional reduction, count nothing there, and a scaled Concrete entry
    times an element counts 2 wide.  ``words=False`` is the limb count
    (limbs at every field).  Monolith's generic body on limbs: per barred
    element per round a REDC out of Montgomery form and a product by R^2
    back, t-1 squarings per round, t^2 L wide scalings per scaled Concrete
    (the entry times a limb word, summed in 64-bit columns) and L per fold
    of its high part, or t lazily summed rows per dense Concrete, L narrow
    products per 32-bit fold the plan takes, and the exit; its Mersenne body
    keeps one canonical word per element, so a squaring or a matrix entry is
    one wide product."""
    from sponge_tpu_torch.fields import GOLDILOCKS_FR
    from sponge_tpu_torch.ops.bounds import (
        check_anemoi_bounds,
        check_griffin_bounds,
        check_monolith_bounds,
        m4_structured,
        p2_plan,
    )

    t, L = cfg.t, cfg.field.nlimbs
    p = cfg.field.modulus
    two = words and p == GOLDILOCKS_FR.modulus
    if name == "monolith_permute":
        mm, sq, row, redc = 2 * L * L, L * (L + 1) // 2 + L * L, (t + 1) * L * L, L * L + L
        plan, R, u = check_monolith_bounds(cfg), cfg.rounds, cfg.bars
        if plan.body == "mersenne":
            return R * (t - 1) + (R + 1) * t * t, 0
        f_sq, f_add, f_conc, f_rc = plan.folds
        scaled = plan.concrete == "scaled"
        if two:
            return (R + 1) * t * t * (2 if scaled else 4) + R * (t - 1) * 3 + 2 * t * 4, 0
        conc = t * t * L + t * f_conc * L if scaled else t * row
        wide = (R + 1) * conc + R * (u * (redc + mm) + (t - 1) * sq) + t * mm
        narrow = R * ((t - 1) * (f_sq + f_add) + t * f_rc) * L + (0 if scaled else (R + 1) * t * f_conc * L)
        return wide, narrow
    word = words and p < 1 << 31

    def add(*terms):  # sums of (count, (wide, narrow)) terms
        return sum(n * c[0] for n, c in terms), sum(n * c[1] for n, c in terms)

    if word:
        mm = sq = (2, 1)
        redc = (1, 1)  # a REDC, or the reduction of a 64-bit sum

        def row_of(n):  # n products summed in 64 bits, one REDC
            return n + 1, 1

        def power(e):
            return 2 * chain_products(e, 1, 1), chain_products(e, 1, 1)

        def scaling(total):  # one small-integer scaling of a word, summed to ``total`` times p
            return (1, 0) if total * (p - 1) >= 1 << 32 else (0, 1)

        lw, io = 1, 2 * t  # words per element; the entry's and exit's products
    elif two:
        mm, sq = (4, 0), (3, 0)

        def row_of(n):  # n products summed in 128 bits, one reduction (no product)
            return 4 * n, 0

        def power(e):
            return chain_products(e, 3, 4), 0

        def scaling(total):  # a small integer times one 32-bit word of an element
            return 1, 0

        lw, io = 2, 2 * t
    else:
        mm, sq = (2 * L * L, 0), (L * (L + 1) // 2 + L * L, 0)

        def row_of(n):
            return (n + 1) * L * L, 0

        def power(e):
            return chain_products(e, sq[0], mm[0]), 0

        def scaling(total):
            return 0, 1

        lw, io = L, t
    row = row_of(t)
    sb = power(cfg.alpha)
    if name in ("poseidon_permute_opt", "poseidon_permute_dense"):
        full = add((cfg.full_rounds * t, sb), (cfg.full_rounds * t, row))
        if name == "poseidon_permute_dense":
            return add((1, full), (cfg.partial_rounds, sb), (cfg.partial_rounds * t, row))
        return add((1, full), (1, sb), (cfg.partial_rounds - 1, row), ((cfg.partial_rounds - 1) * (t - 1), mm),
                   (cfg.partial_rounds - 1, sb), (t, row))
    if name == "poseidon2_permute":
        row_sum = max(sum(r) for r in cfg.mat_e)
        if word:
            dense = add((t * t, scaling(row_sum)), (t, redc))
            k = t // 4
            chain = add((8 * k + 4 * (k - 1) + t, (0, 1)), (t, redc)) if m4_structured(cfg.mat_e) else dense
            ext = min(dense, chain, key=lambda c: 2 * c[0] + c[1])
            diag = (t, scaling(t + max(cfg.diag_m1))) if cfg.small_diag else (t, mm)
            return add((cfg.full_rounds * t, sb), (cfg.full_rounds + 1, ext), (cfg.partial_rounds, sb),
                       (cfg.partial_rounds, (diag[0] * diag[1][0], diag[0] * diag[1][1])),
                       (cfg.partial_rounds, redc), (io, mm))
        wide = cfg.full_rounds * t * sb[0] + cfg.partial_rounds * (sb[0] + (0 if cfg.small_diag else t * mm[0]))
        narrow = (cfg.full_rounds + 1) * t * t * L + (cfg.partial_rounds * t * L if cfg.small_diag else 0)
        return wide + t * mm[0], narrow + p2_plan(cfg).min_folds * L
    if name == "rescue_permute":
        if two:  # narrow rows: the two 32-bit halves times a small entry, 2 t a row (ops/bounds.py)
            from sponge_tpu_torch.ops.bounds import check_rescue_gl_bounds

            row = (2 * t, 0) if check_rescue_gl_bounds(cfg).narrow else row
        per_round = add((t, sb), (t, power(cfg.inv_alpha)), (2 * t, row))
        return add((cfg.rounds, per_round), (io, mm))
    if name == "gmimc_permute":  # the deferred adds are not products
        return add((cfg.rounds, sb), (io, mm))
    if name == "griffin_permute":
        # gates: (i-1) y0 scaled word by word (narrow; wide on two words),
        # L_i^2, alpha_i L_i, x_i quad; the post-linear reduction only where
        # the plan needs it, and none on two words
        gates = add((t - 2, sq), (2 * (t - 2), mm), ((t - 3) * lw, scaling(0) if two else (0, 1)))
        linear = add((t * t * lw, scaling(max(sum(r) for r in cfg.mat_e))),
                     (t if check_griffin_bounds(cfg).reduce and not two else 0, mm))
        per_round = add((1, power(cfg.inv_alpha)), (1, sb), (1, gates))
        return add((cfg.rounds + 1, linear), (cfg.rounds, per_round), (io, mm))
    if name == "anemoi_permute":
        # per pair: y^2, g y^2, u^(1/alpha), v^2, g v^2 (subtractions are
        # additions); M_x rows lazily summed where l > 1; the post-PHT
        # reduction only where the plan needs it, and none on two words
        lc = cfg.l
        diffusion = add((2 * lc if lc > 1 else 0, row_of(lc)),
                        (t if check_anemoi_bounds(cfg).reduce and not two else 0, mm))
        per_round = add((lc, add((2, sq), (2, mm), (1, power(cfg.inv_alpha)))), (1, diffusion))
        return add((cfg.rounds, per_round), (1, diffusion), (io, mm))
    raise ValueError(name)


def bound(work, state_bytes, rates):
    """(bound_ms, bound_by) of one call: ``work`` (wide, narrow) multiply-adds
    over ``rates`` {"wide", "narrow"} (per second; both on the same integer
    pipe, so their times add), against ``state_bytes`` over the memory
    rate."""
    ops_ms = (work[0] / rates["wide"] + work[1] / rates["narrow"]) * 1e3
    bytes_ms = state_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kernel_bound(name, cfg, batch, rates, words=True):
    """``bound`` of one permutation call at ``batch`` lanes: the state read
    once and written once (``limb_products``'s count, ``words`` as
    there)."""
    wide, narrow = limb_products(name, cfg, words)
    return bound((wide * batch, narrow * batch), 2 * cfg.t * cfg.field.nlimbs * 4 * batch, rates)


@functools.lru_cache(maxsize=None)
def sass_listing(lib_path):
    """``cuobjdump -sass`` of the whole library, run once: the census and
    the probes read many functions of it."""
    from sponge_tpu_torch.ops import _build

    return run([str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(lib_path)])


def sass_counts(lib_path, function_key):
    """Opcode counts of the one function of ``lib_path`` whose mangled name
    holds ``function_key`` (cuobjdump -sass)."""
    counts, inside = {}, False
    for line in sass_listing(lib_path).splitlines():
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


def ptxas_entries(report):
    """{mangled kernel name: (registers, spill store bytes, spill load bytes)}
    from a ``ptxas -v`` report."""
    out, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m[1]), *spills)
    return out


def window_phase(cfgs, report):
    """Kernels 5, 6 and 7 per instantiated config: the windows
    (``rescue.config.windows``, ``griffin.config.window``,
    ``anemoi.config.window``), the table's shared bytes per block, the
    compiled registers and spills, and the blocks per SM (kernel 6 with its
    staged constants).  Fails unless the window rule picks the shipped
    windows at the compiled registers too (``_build.REGISTERS`` is the
    rule's input).  Kernel 5's two-word body (Goldilocks) has no window:
    its line gives the body, the registers, spills and blocks per SM with
    its staged word buffer.  Kernel 3 raises only x^alpha (no window, no
    table): its line gives the body, the registers, spills and blocks per
    SM with its staged constants."""
    import sponge_tpu_torch as st
    from sponge_tpu_torch.anemoi.config import pairwise, window
    from sponge_tpu_torch.griffin.config import window as griffin_window
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.bounds import check_p2_bounds
    from sponge_tpu_torch.ops.montgomery import blocks_per_sm, wide_state, window_for, window_table_bytes
    from sponge_tpu_torch.ops.rescue import body as rescue_body
    from sponge_tpu_torch.rescue.config import windows

    entries = ptxas_entries(report)

    def compiled(base, want):
        found = [v for k, v in entries.items() if f"{base}I" in k and template_args(k) == want]
        check(len(found) == 1, f"ptxas report: {len(found)} entries for {base} {want}")
        return found[0]

    for cfg in cfgs:
        t, L = cfg.t, cfg.field.nlimbs
        if isinstance(cfg, st.Poseidon2Config):
            base, want, shared = census_instance("poseidon2_permute", cfg)
            regs, spill_st, spill_ld = compiled(base, want)
            say("window", f"{base} {want} {cfg.field.name} t={t}: x^{cfg.alpha} only, no window table "
                f"({check_p2_bounds(cfg).body} body); ptxas {regs} registers, spills {spill_st} B stored, "
                f"{spill_ld} B loaded; {shared:,} B of staged constants, {blocks_per_sm(regs, shared)} blocks per SM")
            continue
        want = (t, L)
        if isinstance(cfg, st.RescueConfig) and rescue_body(cfg) == "two-word":
            base, want, shared = census_instance("rescue_permute", cfg)
            regs, spill_st, spill_ld = compiled(base, want)
            say("window", f"{base} {want} {cfg.field.name} t={t}: two-word body, no window table "
                f"({rescue_plan_text(cfg)}); ptxas {regs} registers, spills {spill_st} B stored, {spill_ld} B "
                f"loaded; {shared:,} B of staged constants, {blocks_per_sm(regs, shared)} blocks per SM")
            continue
        if isinstance(cfg, st.RescueConfig):  # one chain at a wide state; the round order a template flag
            symbol, kernel, chains = "sponge_rescue", "rescue_kernel", 1 if wide_state(t, L) else t
            exps, shipped, want = (cfg.alpha, cfg.inv_alpha), windows(cfg), (t, L, int(cfg.mds_first))
        elif isinstance(cfg, st.GriffinConfig):
            symbol, kernel, chains = "sponge_griffin", "griffin_kernel", 1
            exps, shipped = (cfg.inv_alpha,), (griffin_window(cfg),)
        else:  # one chain where the Flystel runs one pair at a time
            symbol, kernel, chains = "sponge_anemoi", "anemoi_kernel", 1 if pairwise(cfg) else t // 2
            exps, shipped = (cfg.inv_alpha,), (window(cfg),)
        regs, spill_st, spill_ld = compiled(kernel, want)
        got = tuple(window_for(e, L, chains, regs) for e in exps)
        check(got == shipped, f"{kernel} ({t}, {L}): {regs} registers give windows {got}, the shipped ones are "
              f"{shipped} (at {_build.registers(symbol, t, L)} registers in _build.REGISTERS)")
        table = window_table_bytes(chains, L, max(shipped))
        shared = census_instance("griffin_permute", cfg)[2] if kernel == "griffin_kernel" else table
        say("window", f"{kernel} {cfg.field.name} t={t} L={L}: w "
            f"{'(alpha, 1/alpha) ' + str(shipped) if len(shipped) > 1 else shipped[0]}, table {table:,} B of shared "
            f"memory per block ({shared:,} B with the staged constants); ptxas {regs} registers "
            f"({_build.registers(symbol, t, L)} recorded), spills {spill_st} B stored, {spill_ld} B loaded; "
            f"{blocks_per_sm(regs, shared)} blocks per SM ({blocks_per_sm(regs, 0)} by registers alone)")


CENSUS_OPS = ("IMAD.WIDE.U32", "IMAD", "IADD3", "LOP3", "SHF", "MOV", "LDG")


def census(counts):
    """SASS opcode counts in ``CENSUS_OPS`` groups: IMAD.WIDE.U32 with its
    .X form, IMAD the other IMAD forms except IMAD.MOV, which ptxas emits as
    a move and is counted under MOV, IADD3 with .X, LOP3, SHF and LDG in
    every form."""
    out = dict.fromkeys(CENSUS_OPS, 0)
    for op, n in counts.items():
        if op.startswith("IMAD.WIDE"):
            out["IMAD.WIDE.U32"] += n
        elif op.startswith("IMAD.MOV"):
            out["MOV"] += n
        elif op.split(".")[0] in out:
            out[op.split(".")[0]] += n
    return out


def template_args(mangled):
    """The integer template arguments of a mangled kernel name."""
    args = re.findall(r"L[a-z](n?\d+)E", mangled.split("kernelI", 1)[1].split("EEv", 1)[0])
    return tuple(int(v.replace("n", "-")) for v in args)


CENSUS_KERNELS = (
    ("kernel 1 (limb body: t, L; two-word body: t)", "poseidon_opt_kernel"),
    ("kernel 2, limb body", "poseidon_dense_kernel"),
    ("kernel 2, one-word body", "poseidon_dense_word_kernel"),
    ("kernel 2, two-word body", "poseidon_dense_gl_kernel"),
    ("kernel 3, limb body", "poseidon2_kernel"),
    ("kernel 3, one-word body", "poseidon2_word_kernel"),
    ("kernel 4, generic body", "monolith_kernel"),
    ("kernel 4, Mersenne body", "monolith_mersenne_kernel"),
    ("kernel 5", "rescue_kernel"),
    ("kernel 6", "griffin_kernel"),
    ("kernel 7", "anemoi_kernel"),
    ("kernel 8, limb body", "gmimc_kernel"),
    ("kernel 8, two-word body", "gmimc_word_kernel"),
)


def census_instance(name, cfg, body=None):
    """(kernel name, template arguments, bytes of shared memory per block)
    of the instantiation that runs ``cfg`` (kernel 8: with ``body``, that
    body's, its limb body's with or without its front reduction
    as the replay asks): kernels 1, 2, 3, 4, 6 and 8 stage their constants
    in shared memory (kernel 2: the limb body p | ark | mds, a word body its
    own buffer; kernels 3 and 8: the limb body its limb sections, the one-
    or two-word body its word section), kernel 6 its window table after
    them; kernels 5 and 7 hold only their window tables there (one chain at
    a wide state, kernel 7 from three pairs on)."""
    from sponge_tpu_torch.griffin.config import constant_layout as griffin_layout
    from sponge_tpu_torch.griffin.config import window as griffin_window
    from sponge_tpu_torch.monolith.config import constant_layout as monolith_layout
    from sponge_tpu_torch.ops.bounds import check_monolith_bounds, check_p2_bounds
    from sponge_tpu_torch.ops.monolith import chunk_pattern, plan_code
    from sponge_tpu_torch.ops.montgomery import window_table_bytes
    from sponge_tpu_torch.poseidon.config import constant_layout, layout_size
    from sponge_tpu_torch.poseidon2.config import LIMB_SECTIONS
    from sponge_tpu_torch.poseidon2.config import constant_layout as p2_layout

    t, L = cfg.t, cfg.field.nlimbs
    if name == "poseidon_permute_opt":
        from sponge_tpu_torch.ops import poseidon_opt

        if poseidon_opt.body(cfg) == "two-word":
            return "poseidon_opt_kernel", (t,), 4 * len(poseidon_opt.word_constants(cfg))
        return "poseidon_opt_kernel", (t, L), 4 * layout_size(constant_layout(cfg))
    if name == "poseidon_permute_dense":
        from sponge_tpu_torch.ops import poseidon_dense

        kind = poseidon_dense.body(cfg)
        if kind == "limb":
            return "poseidon_dense_kernel", (t, L), 4 * layout_size(constant_layout(cfg)[:3])
        base = "poseidon_dense_word_kernel" if kind == "one-word" else "poseidon_dense_gl_kernel"
        return base, (t,), 4 * len(poseidon_dense.word_constants(cfg))
    if name == "monolith_permute":
        plan = check_monolith_bounds(cfg)
        want = (t, L, chunk_pattern(cfg.field), int(plan.concrete == "scaled"), plan_code(plan.folds))
        base = "monolith_mersenne_kernel" if plan.body == "mersenne" else "monolith_kernel"
        return base, want, 4 * layout_size(monolith_layout(cfg))
    if name == "poseidon2_permute":
        plan, layout = check_p2_bounds(cfg), p2_layout(cfg)
        limb_words = layout_size(layout[:LIMB_SECTIONS])
        if plan.body == "word":  # alpha 3, 5 and 7 have instantiations of their own (csrc/poseidon2.cu)
            want = (t, int(plan.structured), cfg.alpha if cfg.alpha in (3, 5, 7) else 0)
            return "poseidon2_word_kernel", want, 4 * (layout_size(layout) - limb_words)
        return "poseidon2_kernel", (t, L), 4 * limb_words
    if name == "griffin_permute":
        table = window_table_bytes(1, L, griffin_window(cfg))
        return "griffin_kernel", (t, L), 4 * layout_size(griffin_layout(cfg)) + table
    if name == "rescue_permute":
        from sponge_tpu_torch.ops import rescue as rescue_ops
        from sponge_tpu_torch.ops.montgomery import wide_state
        from sponge_tpu_torch.rescue.config import windows

        if rescue_ops.body(cfg) == "two-word":
            return "rescue_kernel", (t, int(cfg.mds_first)), 4 * len(rescue_ops.word_constants(cfg))
        return ("rescue_kernel", (t, L, int(cfg.mds_first)),
                window_table_bytes(1 if wide_state(t, L) else t, L, max(windows(cfg))))
    if name == "anemoi_permute":
        from sponge_tpu_torch.anemoi.config import pairwise, window

        return "anemoi_kernel", (t, L), window_table_bytes(1 if pairwise(cfg) else cfg.l, L, window(cfg))
    if name == "gmimc_permute":
        from sponge_tpu_torch.gmimc import config as gmimc_config

        if not hasattr(gmimc_config, "LIMB_SECTIONS"):  # a tree from before the two-word body: no staging
            return "gmimc_kernel", (t, L), 0
        layout = gmimc_config.constant_layout(cfg)
        limb_words = layout_size(layout[: gmimc_config.LIMB_SECTIONS])
        if (body or gmimc_body(cfg)) == "word":
            return "gmimc_word_kernel", (t,), 4 * (layout_size(layout) - limb_words)
        from sponge_tpu_torch.ops.bounds import check_gmimc_bounds

        return "gmimc_kernel", (t, L, int(check_gmimc_bounds(cfg).reduce)), 4 * limb_words
    raise ValueError(name)


def census_phase(report, cfgs):
    """Kernels 1-4, 6 and 8: every instantiation's ptxas registers,
    spills and blocks per SM of 128 threads by registers; then for the
    instantiation each path times (``cfgs``: (name, config) pairs, or (name,
    config, body) for a kernel 2 or 8 body the config does not take) its blocks
    per SM with the shared memory it takes and the static SASS census
    (``CENSUS_OPS``, the code of one kernel, loops counted once) beside the
    products one permutation needs (``limb_products``)."""
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.montgomery import blocks_per_sm

    entries = ptxas_entries(report)
    for kernel, base in CENSUS_KERNELS:
        found = sorted((template_args(k), v) for k, v in entries.items() if f"{base}I" in k)
        say("census", f"{kernel}, per instantiation (template arguments: registers, spill stores/loads B, blocks "
            f"per SM): " + "; ".join(f"{args}: {r}, {st}/{ld}, {blocks_per_sm(r, 0)}" for args, (r, st, ld) in found))
    lib = _build.library_path()
    for name, cfg, *body in cfgs:
        base, want, shared = census_instance(name, cfg, *body)
        found = [k for k in entries if f"{base}I" in k and template_args(k) == want]
        check(len(found) == 1, f"census: {len(found)} ptxas entries for {base} {want}")
        counts = census(sass_counts(lib, found[0]))
        wide, narrow = limb_products(name, cfg)
        regs, spill_st, spill_ld = entries[found[0]]
        say("census", f"{name} {cfg.field.name} t={cfg.t} ({base} {want}): {regs} registers, spills {spill_st}/"
            f"{spill_ld} B, {shared:,} B of shared memory, {blocks_per_sm(regs, shared)} blocks per SM; static SASS "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; the bound's products per permutation: {wide:,} wide, {narrow:,} 32-bit")


def window_comparison(cfg, state, path_out, gpu):
    """Kernel 5 with its inverse S-box at window 3 and at window 4, each by a
    direct launch with a constant buffer of that window (not counted), in
    turns 3, 4, 4, 3 on the path's input; both outputs must equal the
    path's, and the replay must admit the 4-bit chain."""
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.bounds import _Replay
    from sponge_tpu_torch.ops.montgomery import window_schedule
    from sponge_tpu_torch.rescue.config import kernel_constants, schedules, windows

    w_alpha = windows(cfg)[0]
    alpha_sched, inv_sched = schedules(cfg)
    head = kernel_constants(cfg)[: -len(inv_sched)]
    sim = _Replay(f"Rescue kernel, {cfg.field.name} t={cfg.t}, window 4", cfg.field, terms=cfg.t)
    sim.pow_window(sim.const, cfg.inv_alpha, 4)
    runs = {}
    for w in (3, 4):
        sched = window_schedule(cfg.inv_alpha, w)
        consts = torch.from_numpy(np.concatenate([head, np.asarray(sched, dtype=np.int32)])).to(state.device)
        args = (cfg.rounds, w_alpha, len(alpha_sched), w, len(sched), consts.data_ptr(), cfg.field.n0inv,
                int(cfg.mds_first), 0, None, 0, 0, 0)  # the limb body, no word buffer
        runs[w] = (consts, args)
    best = {}
    for w in (3, 4, 4, 3):
        consts, args = runs[w]
        out = torch.empty_like(state)
        ms, _ = time_ms(lambda: _build.launch("sponge_rescue", state, out, *args), reps=2)
        check(torch.equal(out, path_out), f"kernel 5 at window {w}: output != the path's at B={state.shape[-1]}")
        best[w] = min(best.get(w, float("inf")), ms)
    say("window", f"rescue_permute {cfg.field.name} t={cfg.t} B={state.shape[-1]}, inverse S-box at window 3 "
        f"(shipped: {windows(cfg)[1]}) {best[3]:.3f} ms, at window 4 {best[4]:.3f} ms (in turns 3, 4, 4, 3, best "
        f"of each; both outputs == the path's) [{gpu}]")


def gmimc_body_comparison(cfg, state, path_out, gpu, rates):
    """Kernel 8's limb body beside its two-word body at Goldilocks t = 8,
    each by a direct launch (not counted), in turns limb, word, word, limb
    on the path's input: both outputs must equal the path's (the limb
    body's replay must admit the config).  A tree from before the two-word
    body (a two-tree comparison's parent) has only the limb body, timed on
    its ``[time]`` line: nothing to compare."""
    if gmimc_body(cfg) != "word":
        say("time", f"gmimc_permute {cfg.field.name} t={cfg.t}: one body in this tree, no comparison")
        return
    from sponge_tpu_torch.gmimc.config import LIMB_SECTIONS, constant_layout, kernel_constants
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.bounds import check_gmimc_bounds
    from sponge_tpu_torch.ops.gmimc import _launch_args
    from sponge_tpu_torch.poseidon.config import layout_size

    check_gmimc_bounds(cfg)
    consts = torch.from_numpy(kernel_constants(cfg)).to(state.device)
    limb_words = layout_size(constant_layout(cfg)[:LIMB_SECTIONS])
    args = {"limb": (0, cfg.rounds, cfg.alpha, 0, consts.data_ptr(), limb_words, cfg.field.n0inv),
            "word": _launch_args(cfg, consts)}
    check(args["word"][0] == 1, "gmimc_permute at Goldilocks: the wrapper does not take the two-word body")
    best = {}
    for kind in ("limb", "word", "word", "limb"):
        out = torch.empty_like(state)
        ms, _ = time_ms(lambda: _build.launch("sponge_gmimc", state, out, *args[kind]), reps=2)
        check(torch.equal(out, path_out), f"kernel 8's {kind} body at {cfg.field.name}: output != the path's")
        best[kind] = min(best.get(kind, float("inf")), ms)
    bound_ms, _ = kernel_bound("gmimc_permute", cfg, state.shape[-1], rates)
    limb_ms, _ = kernel_bound("gmimc_permute", cfg, state.shape[-1], rates, words=False)
    say("time", f"gmimc_permute {cfg.field.name} t={cfg.t} B={state.shape[-1]}: limb body ({cfg.t}, "
        f"{cfg.field.nlimbs}) {best['limb']:.3f} ms, two-word body {best['word']:.3f} ms ({best['limb'] / best['word']:.2f}x; "
        f"in turns limb, word, word, limb, best of each; both outputs == the path's); bound {bound_ms:.3f} ms "
        f"(limb {bound_ms / best['limb']:.1%}, word {bound_ms / best['word']:.1%}), "
        f"{limb_ms:.3f} ms by the limb count [{gpu}]")


def opt_plan_text(cfg):
    """Kernel 1's body and its replay (``ops/bounds.py``
    ``check_opt_gl_bounds`` or ``check_kernel_bounds``)."""
    from sponge_tpu_torch.ops import bounds
    from sponge_tpu_torch.ops.poseidon_opt import body

    if body(cfg) == "two-word":
        return f"two-word body, largest accumulator {bounds.check_opt_gl_bounds(cfg) + 1} x 2^128"
    return "limb body, " + value_bound_text(cfg, bounds.check_kernel_bounds(cfg, True))


def rescue_plan_text(cfg):
    """Kernel 5's body and its replay (``ops/bounds.py``
    ``check_rescue_gl_bounds`` or ``check_rescue_bounds``)."""
    from sponge_tpu_torch.ops import bounds
    from sponge_tpu_torch.ops.rescue import body

    if body(cfg) == "two-word":
        plan = bounds.check_rescue_gl_bounds(cfg)
        acc = (f"narrow MDS rows, largest accumulator 2^{(plan.acc - 1).bit_length()}" if plan.narrow else
               f"MDS rows by gl_row, largest row sum {plan.acc + 1} x 2^128")
        return f"two-word body, {'alpha 7 chains' if plan.chain else 'square-and-multiply'}, {acc}"
    return "limb body, " + value_bound_text(cfg, bounds.check_rescue_bounds(cfg))


def dense_plan_text(cfg):
    """Kernel 2's body and its replay (``ops/bounds.py``
    ``check_dense_word_bounds``, ``check_dense_gl_bounds`` or
    ``check_kernel_bounds``)."""
    from sponge_tpu_torch.ops import bounds
    from sponge_tpu_torch.ops.poseidon_dense import body

    kind = body(cfg)
    if kind == "one-word":
        return f"one-word body, largest row total {bounds.check_dense_word_bounds(cfg) / cfg.field.modulus:.1f}p"
    if kind == "two-word":
        return f"two-word body, largest row sum {bounds.check_dense_gl_bounds(cfg) + 1} x 2^128"
    return "limb body, " + value_bound_text(cfg, bounds.check_kernel_bounds(cfg, False))


def probe_phase(st, dev, rng, gpu, peak):
    """The probe kernels, launches counted: dependent latencies, saturated
    rates against the ``peak`` rates every bound divides by, SASS counts,
    one against two Montgomery chains, and the ablation of kernel 1.  Every
    timed run's output equals the plain version at the same chains and
    steps on lanes from both ends of its plane (uint32_probe's semantics
    check).  Returns the two probes' summary entries."""
    from sponge_tpu_torch.ops import _build, probe
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt
    from sponge_tpu_torch.family import permutation_for

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
        f"{rows['pow'] - rows['ark']:.3f}, the full rounds' MDS {rows['full_mds'] - rows['pow']:.3f}, the sparse "
        f"phase (c_r adds, sparse linear layers, D) {rows['full'] - rows['full_mds']:.3f} ms; plain "
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


def main(argv):
    """The whole drive with no arguments; ``--only NAME[,NAME]`` (names of
    the ``kernels`` table) builds, prints the window and census lines, holds
    the named kernels against their plain versions and the oracle, and
    times them at the paths' widths, with no probe phase and no path."""
    only = set(argv[1].split(",")) if argv[:1] == ["--only"] and len(argv) == 2 else None
    if argv and only is None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
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
        check_griffin_bounds,
        check_kernel_bounds,
        check_monolith_bounds,
        check_p2_bounds,
    )
    from sponge_tpu_torch.ops.gmimc import gmimc_permute, gmimc_permute_plain
    from sponge_tpu_torch.ops.griffin import griffin_permute, griffin_permute_plain
    from sponge_tpu_torch.ops.poseidon2 import permute_p2, permute_p2_plain
    from sponge_tpu_torch.ops.poseidon_dense import BODIES as dense_bodies
    from sponge_tpu_torch.ops.poseidon_dense import permute_dense, permute_dense_plain
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt, permute_opt_plain
    from sponge_tpu_torch.ops.rescue import BODIES as rescue_bodies
    from sponge_tpu_torch.ops.rescue import rescue_permute, rescue_permute_plain
    from sponge_tpu_torch.family import permutation_for

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    start = time.perf_counter()

    def elapsed(phase):
        say("elapsed", f"{time.perf_counter() - start:.1f} s at the start of {phase}")

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
        if line.startswith("# ") and line.endswith(" s"):
            say("build", line[2:])
        elif "Compiling entry" in line or "registers" in line or "spill" in line:
            say("ptxas", line.strip())

    elapsed("the probes")
    # ---- 2. the probes: the integer rates every bound below rests on ----
    rates = {"wide": SMS * WIDE_PER_CLOCK * sm_clock_hz, "narrow": SMS * IMAD_PER_CLOCK * sm_clock_hz}
    probe_entries = probe_phase(st, dev, rng, gpu, rates) if only is None else {}
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
    p2_kb = st.get_default_poseidon2_parameters(st.KOALABEAR_FR, 8)
    p2_m31 = st.get_default_poseidon2_parameters(st.MERSENNE31_FR, 8)
    # kernel 3's one-word body with dense M_E rows: the BabyBear and 25-bit
    # t = 8 configs with their matrices' rows reversed (no longer
    # circ(2 M4, M4, ...)), and the 25-bit t = 3 config
    p2_bb_dense = dataclasses.replace(p2_bb, mat_e=tuple(reversed(p2_bb.mat_e)))
    p2_25 = st.generate_poseidon2_parameters(fr25, 7, 5, 4, 4)
    p2_25_dense = dataclasses.replace(p2_25, mat_e=tuple(reversed(p2_25.mat_e)))
    p2_25_t3 = st.generate_poseidon2_parameters(fr25, 2, 5, 4, 8)
    p2_tiny = st.generate_poseidon2_parameters(tiny_fs, 2, 5, 4, 8)
    p2_low = st.generate_poseidon2_parameters(low_fs, 7, 5, 4, 4)
    r_bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    r_bb = st.get_default_rescue_parameters(st.BABYBEAR_FR, 8)
    r_25 = st.generate_rescue_parameters(fr25, 2, rounds=4)
    gl = st.GOLDILOCKS_FR
    r_gl = st.get_default_rescue_parameters(gl, 8)  # kernel 5's two-word body, (12, 3)
    r_gl11 = st.generate_rescue_parameters(gl, 4, 4, alpha=11, rounds=3)  # its square-and-multiply chains
    m_bls = st.get_default_gmimc_parameters(st.BLS12_381_FR, 2)
    m_bn = st.get_default_gmimc_parameters(st.BN254_FR, 2)
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
    pos_gl = st.get_default_poseidon_parameters(gl, 4)  # kernels 1 and 2's two-word bodies, (8, 3)
    pos_bb = st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8)  # its one-word body, (16, 2)
    mo_gl = st.get_default_monolith_parameters(gl)
    mo_gl8 = st.get_default_monolith_parameters(gl, 4)
    mo_m31 = st.get_default_monolith_parameters(st.MERSENNE31_FR)
    mo_kb = st.get_default_monolith_parameters(st.KOALABEAR_FR)
    mo_bb = st.get_default_monolith_parameters(st.BABYBEAR_FR)
    mo_kb4 = st.generate_monolith_parameters(st.KOALABEAR_FR, 2, 2, 6, 2)
    mo_m314 = st.generate_monolith_parameters(st.MERSENNE31_FR, 2, 2, 6, 2)
    window_phase([r_bls, r_bb, r_25, st.get_rpo_parameters(gl), g_bls, g_gl, g_25, a_bls, a_bls1, a_gl, a_25, p2_bls,
                  p2_bb, p2_bb_dense, p2_25, p2_25_dense, p2_25_t3, p2_tiny, p2_low]
                 + [cfg for name, _, cfg in family_configs(st) if name != "gmimc_permute"], _build.ptxas_report())
    census_phase(_build.ptxas_report(), [("poseidon_permute_opt", bls), ("poseidon_permute_opt", pos_gl),
                                         ("poseidon_permute_dense", bls),
                                         ("poseidon_permute_dense", pos_bb), ("poseidon_permute_dense", pos_gl),
                                         ("monolith_permute", mo_gl),
                                         ("monolith_permute", mo_m31), ("poseidon2_permute", p2_bls),
                                         ("poseidon2_permute", p2_bb), ("poseidon2_permute", p2_kb),
                                         ("poseidon2_permute", p2_bb_dense), ("griffin_permute", g_bls),
                                         ("griffin_permute", g_gl), ("gmimc_permute", m_bls),
                                         ("gmimc_permute", m_gl), ("gmimc_permute", m_gl, "limb"),
                                         ("rescue_permute", r_bls), ("rescue_permute", r_gl),
                                         ("rescue_permute", st.get_rpo_parameters(gl))])

    elapsed("the golden vectors")
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

    elapsed("the kernel checks")
    # ---- 4. each kernel against its plain version ----
    kernels = {
        "poseidon_permute_opt": dict(
            wrapper=permute_opt, plain=permute_opt_plain, words="opt_words",
            bound=opt_plan_text,
            configs=[bls, bn, tiny, pos_gl],
            source="sponge_tpu_torch/csrc/poseidon_opt.cu",
            replaces="sponge_tpu/ops/pallas_cios.py:1248",
        ),
        "poseidon_permute_dense": dict(
            wrapper=permute_dense, plain=permute_dense_plain, words="words",
            bound=dense_plan_text,
            configs=[bls, bn, tiny, pos_gl, pos_bb],
            source="sponge_tpu_torch/csrc/poseidon_dense.cu",
            replaces="sponge_tpu/ops/pallas_permute.py:96",
            bodies={kind: {"source": "sponge_tpu_torch/csrc/" + ("poseidon_dense.cu" if kind == "limb" else
                                                                  "poseidon_dense_words.cu"),
                           "pairs": sorted(pairs)} for kind, pairs in dense_bodies.items()},
        ),
        "poseidon2_permute": dict(
            wrapper=permute_p2, plain=permute_p2_plain,
            bound=lambda cfg: p2_plan_text(cfg, check_p2_bounds(cfg)),
            configs=[p2_bls, p2_bn, p2_bb, p2_kb, p2_m31, p2_bb_dense, p2_25, p2_25_dense, p2_25_t3, p2_tiny,
                     p2_low],
            source="sponge_tpu_torch/csrc/poseidon2.cu",
            replaces="sponge_tpu/ops/pallas_p2.py:314",
        ),
        "rescue_permute": dict(
            wrapper=rescue_permute, plain=rescue_permute_plain, words="words",
            bound=rescue_plan_text,
            configs=[r_bls, r_bb, r_25, r_gl, r_gl11],
            source="sponge_tpu_torch/csrc/rescue.cu",
            replaces="sponge_tpu/ops/pallas_rescue.py:438",
            bodies={kind: {"source": "sponge_tpu_torch/csrc/" + ("rescue.cu" if kind == "limb" else
                                                                  "rescue_words.cu"),
                           "pairs": sorted(pairs)} for kind, pairs in rescue_bodies.items()},
        ),
        "griffin_permute": dict(
            wrapper=griffin_permute, plain=griffin_permute_plain,
            bound=lambda cfg: plan_text(cfg, check_griffin_bounds(cfg)),
            configs=[g_bls, g_gl, g_25],
            source="sponge_tpu_torch/csrc/griffin.cu",
            replaces="sponge_tpu/ops/pallas_griffin.py:334",
        ),
        "anemoi_permute": dict(
            wrapper=anemoi_permute, plain=anemoi_permute_plain,
            bound=lambda cfg: plan_text(cfg, check_anemoi_bounds(cfg)),
            configs=[a_bls, a_bls1, a_gl, a_25],
            source="sponge_tpu_torch/csrc/anemoi.cu",
            replaces="sponge_tpu/ops/pallas_anemoi.py:372",
        ),
        "gmimc_permute": dict(
            wrapper=gmimc_permute, plain=gmimc_permute_plain,
            bound=gmimc_plan_text,
            configs=[m_bls, m_bn, m_gl, m_25],
            source="sponge_tpu_torch/csrc/gmimc.cu",
            replaces="sponge_tpu/ops/pallas_gmimc.py:150",
        ),
        "monolith_permute": dict(
            wrapper=monolith_permute, plain=monolith_permute_plain,
            bound=lambda cfg: monolith_plan_text(check_monolith_bounds(cfg)),
            configs=[mo_gl, mo_gl8, mo_m31, mo_kb, mo_bb, mo_kb4, mo_m314],
            source="sponge_tpu_torch/csrc/monolith.cu",
            replaces="sponge_tpu/ops/pallas_monolith.py:722",
        ),
    }
    for k in kernels.values():
        k["max_abs_err"] = 0
    for name, k in kernels.items():
        if only is not None and name not in only:
            continue
        for cfg in k["configs"]:
            B = B_LADDER_PLAIN if id(cfg) in ladder_plain else B_CHECK
            perm = permutation_for(cfg, dev)
            state = with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B), rng, dev))
            bound_text = k["bound"](cfg)
            before = k["wrapper"].launches
            out_k = call_kernel(k, cfg, perm, state)
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

    # timing at the paths' shapes, beside each kernel's bound; the plain
    # version's timed run is on the path's own input lanes and must equal the
    # path's output there
    def time_kernel(name, cfg, big, lanes, path_out=None):
        k = kernels[name]
        perm = permutation_for(cfg, dev)
        consts = perm.consts
        small = big[..., lanes]
        ms, _ = time_ms(lambda: call_kernel(k, cfg, perm, big))
        # the plain version: one run, no warm-up (a ladder family's plain
        # version is some 10^5 launches, 7-17 s on the card's host)
        plain_ms, plain_out = time_ms(lambda: k["plain"](cfg, consts, small), reps=1, warm=False)
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
        limb_ms, _ = kernel_bound(name, cfg, big.shape[-1], rates, words=False)
        wide, narrow = limb_products(name, cfg)
        recount = (f"; by the limb count before the two-word recount {limb_ms:.3f} ms, {limb_ms / ms:.1%} of it"
                   if cfg.field.name == gl.name else "")
        say(
            "time",
            f"{name} {cfg.field.name} t={cfg.t} B={big.shape[-1]}: kernel {ms:.3f} ms = "
            f"{big.shape[-1] / ms * 1e3:,.0f} perms/s; bound {out['bound_ms']:.3f} ms "
            f"({out['bound_by']}, {out['bound_ms'] / ms:.1%} of it; {wide:,} wide + {narrow:,} 32-bit products "
            f"per permutation at the peaks of {WIDE_PER_CLOCK} and {IMAD_PER_CLOCK} per clock per SM; "
            f"{flat_ms:.3f} ms at {IMAD_PER_CLOCK} for both{recount}); "
            f"plain torch {plain_ms:.1f} ms at B={n} = {n / plain_ms * 1e3:,.0f} perms/s [{gpu}]",
        )
        return out

    every = slice(None)
    half = B_LADDER_PLAIN // 2  # the ladder families' plain lanes: both ends of the 2^20 plane
    ends = torch.cat([torch.arange(half), torch.arange(B_MAIN - half, B_MAIN)]).to(dev)
    if only is not None:
        for name, cfg, lanes in (("poseidon_permute_opt", bls, every), ("poseidon_permute_dense", bls, every),
                                 ("poseidon2_permute", p2_bls, every), ("poseidon2_permute", p2_bb, every),
                                 ("poseidon2_permute", p2_kb, every), ("poseidon2_permute", p2_bb_dense, every),
                                 ("griffin_permute", g_bls, ends), ("griffin_permute", g_gl, every),
                                 ("gmimc_permute", m_bls, every), ("gmimc_permute", m_gl, every),
                                 ("rescue_permute", r_bls, ends), ("anemoi_permute", a_bls, ends)):
            if name in only:
                k = kernels[name]
                big = with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
                big_out = call_kernel(k, cfg, permutation_for(cfg, dev), big)
                time_kernel(name, cfg, big, lanes, big_out)
                if cfg is m_gl:
                    gmimc_body_comparison(cfg, big, big_out, gpu, rates)
        if only & {"poseidon_permute_opt", "poseidon_permute_dense", "poseidon2_permute"}:
            elapsed("the widths")
            widths_phase(st, dev, rng, gpu, kernels, rates, _build.ptxas_report())
        if only & set(FAMILY_KERNELS):
            elapsed("the family widths")
            family_widths_phase(st, dev, rng, gpu, kernels, rates, _build.ptxas_report())
        if OVERWRITE_PHASE in only:
            elapsed("the overwrite sponge")
            overwrite_phase(st, dev, rng, gpu)
        if RPO_PHASE in only:
            elapsed("the RPO path")
            rpo_phase(st, dev, rng, gpu, rates)
        if OCTTREE_PHASE in only:
            elapsed("the Filecoin tree")
            octtree_phase(st, dev, rng, gpu, rates)
        elapsed("the end")
        return 0

    elapsed("the Poseidon path")
    # ---- 5. the Poseidon path (kernels 1 and 2), launches counted ----
    fs = bls.field
    perm = permutation_for(bls, dev)
    state = with_edges(fs, random_plane(fs, (bls.t, fs.nlimbs, B_MAIN), rng, dev))
    leaves = random_plane(fs, (fs.nlimbs, B_MAIN), rng, dev)
    lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    out = st.batched_permute(bls, state)  # kernel 1
    parity = permute_dense(bls, perm.consts, state, perm.words)  # kernel 2: the second parity tier
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

    elapsed("the Poseidon2/Rescue path")
    # ---- 6. the Poseidon2 and Rescue-Prime path (kernels 3 and 5), launches counted ----
    p2_states = {
        cfg.field.name: with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
        for cfg in (p2_bls, p2_bb, p2_kb)
    }
    r_state = with_edges(fs, random_plane(fs, (r_bls.t, fs.nlimbs, B_MAIN), rng, dev))
    p2_leaves = random_plane(fs, (fs.nlimbs, B_MAIN), rng, dev)
    r_lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    p2_out = {cfg.field.name: st.batched_permute(cfg, p2_states[cfg.field.name]) for cfg in (p2_bls, p2_bb, p2_kb)}
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

    for cfg in (p2_bls, p2_bb, p2_kb):
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

    elapsed("the overwrite sponge")
    # ---- 6b. kernel 3's overwrite sponge at the MMCS cell's sizes, launches counted ----
    launches["poseidon2_permute"] += overwrite_phase(st, dev, rng, gpu)["poseidon2_permute"]

    elapsed("the RPO path")
    # ---- 6c. kernel 5's MDS-first order at the Miden cell's sizes, launches counted ----
    launches["rescue_permute"] += rpo_phase(st, dev, rng, gpu, rates)["rescue_permute"]

    elapsed("the Filecoin tree")
    # ---- 6d. kernel 1's tagged step at the Filecoin cell's sizes, launches counted ----
    launches["poseidon_permute_opt"] += octtree_phase(st, dev, rng, gpu, rates)["poseidon_permute_opt"]

    elapsed("the GMiMC/Griffin/Anemoi path")
    # ---- 7. the GMiMC, Griffin and Anemoi path (kernels 8, 6 and 7), launches counted ----
    fam_cfgs = (m_bls, g_bls, a_bls, m_gl, g_gl, a_gl)
    fam_states = {
        id(cfg): with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_MAIN), rng, dev))
        for cfg in fam_cfgs
    }
    for cfg in (m_bls, m_gl):  # kernel 8's near-bound lanes
        fam_states[id(cfg)] = with_maxima(cfg.field, fam_states[id(cfg)])
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
        # kernel 8: also the lane of p-1 in elements 0-2 and the near-bound lanes
        sample = main_sample[::2] + ([42, *NEAR_BOUND_LANES] if family == "GMiMC" else [])
        check_lanes_vs_oracle(cfg, fam_states[id(cfg)], fam_out[id(cfg)], sample, f"{what} B=2^20")
        say("main", f"batched_permute {what} at B=2^20: {len(sample)} lanes == oracle"
            + (f" (near-bound lanes 42, {NEAR_BOUND_LANES[0]}, {NEAR_BOUND_LANES[1]} among them)"
               if family == "GMiMC" else ""))
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

    elapsed("the Monolith path")
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

    elapsed("the sharded/Jive/checkpoint path")
    # ---- 9. the sharded, Jive and checkpoint path (kernels 1, 4, 6 and 7), launches counted ----
    launches5 = sharded_phase(st, dev, rng, gpu, kernels, bls, mo_gl, g_gl, a_bls1)
    for name in SHARDED_PATH_KERNELS:
        launches[name] += launches5[name]

    elapsed("the host runtime/tracer/examples path")
    # ---- 10. the host runtime, the tracer and the examples (kernels 1, 3-8), launches counted ----
    launches6 = host_phase(st, dev, rng, gpu, kernels)
    for name in HOST_PATH_KERNELS:
        launches[name] += launches6[name]

    elapsed("the timing")
    # ---- 11. timing at the paths' shapes (time_kernel) ----
    kernels["poseidon_permute_opt"].update(time_kernel("poseidon_permute_opt", bls, state, every, out))
    kernels["poseidon_permute_dense"].update(time_kernel("poseidon_permute_dense", bls, state, every, parity))
    k1, k2 = kernels["poseidon_permute_opt"]["ms"], kernels["poseidon_permute_dense"]["ms"]
    say("time", f"kernel 1 (\"auto\") {k1:.3f} ms against kernel 2 (\"dense\") {k2:.3f} ms on the same input: "
        f"kernel 1 {'faster' if k1 < k2 else 'not faster'} ({k2 / k1:.3f}x) [{gpu}]")
    for cfg in (p2_bls, p2_bb, p2_kb):
        name = cfg.field.name
        timed = time_kernel("poseidon2_permute", cfg, p2_states[name], every, p2_out[name])
        if cfg is p2_bls:  # BabyBear and KoalaBear t = 16 are the path's other widths, not in the summary line
            kernels["poseidon2_permute"].update(timed)
    # the one-word body with dense M_E rows beside the structured chain (the choice the census explains)
    time_kernel("poseidon2_permute", p2_bb_dense, p2_states[p2_bb.field.name], every,
                kernels["poseidon2_permute"]["wrapper"](p2_bb_dense, permutation_for(
                    p2_bb_dense, dev).consts, p2_states[p2_bb.field.name]))
    kernels["rescue_permute"].update(time_kernel("rescue_permute", r_bls, r_state, ends, r_out))
    window_comparison(r_bls, r_state, r_out, gpu)
    time_kernel("rescue_permute", r_bb, p2_states[p2_bb.field.name], slice(0, B_CHECK))
    for name, cfg, lanes in (("gmimc_permute", m_bls, every), ("griffin_permute", g_bls, ends),
                             ("anemoi_permute", a_bls, ends)):
        kernels[name].update(time_kernel(name, cfg, fam_states[id(cfg)], lanes, fam_out[id(cfg)]))
    for name, cfg in (("gmimc_permute", m_gl), ("griffin_permute", g_gl), ("anemoi_permute", a_gl)):
        time_kernel(name, cfg, fam_states[id(cfg)], every, fam_out[id(cfg)])  # the path's other width
    gmimc_body_comparison(m_gl, fam_states[id(m_gl)], fam_out[id(m_gl)], gpu, rates)
    # the Jive path's Anemoi width, t = 2 (one Flystel pair): the kernel alone beside its bound
    a2_state = random_plane(fs, (a_bls1.t, fs.nlimbs, B_MAIN), rng, dev)
    a2_consts = permutation_for(a_bls1, dev).consts
    a2_ms, _ = time_ms(lambda: anemoi_permute(a_bls1, a2_consts, a2_state))
    a2_bound, a2_by = kernel_bound("anemoi_permute", a_bls1, B_MAIN, rates)
    say("time", f"anemoi_permute {fs.name} t={a_bls1.t} B={B_MAIN} (the Jive width): kernel {a2_ms:.3f} ms; bound "
        f"{a2_bound:.3f} ms ({a2_by}) [{gpu}]")
    kernels["monolith_permute"].update(time_kernel("monolith_permute", mo_gl, mo_states[id(mo_gl)], every,
                                                   mo_out[id(mo_gl)]))
    time_kernel("monolith_permute", mo_m31, mo_states[id(mo_m31)], every, mo_out[id(mo_m31)])

    elapsed("the widths")
    # ---- 12. every default Poseidon and Poseidon2 width (kernels 1, 2 and 3), launches counted ----
    launches7 = widths_phase(st, dev, rng, gpu, kernels, rates, _build.ptxas_report())
    for name in WIDTH_PATH_KERNELS:
        launches[name] += launches7[name]

    elapsed("the family widths")
    # ---- 13. every default Rescue-Prime, GMiMC, Griffin and Anemoi width (kernels 5-8), launches counted ----
    launches8 = family_widths_phase(st, dev, rng, gpu, kernels, rates, _build.ptxas_report())
    for name in FAMILY_KERNELS:
        launches[name] += launches8[name]

    elapsed("the summary")
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
            **({"bodies": k["bodies"]} if "bodies" in k else {}),
            **({"instantiations": k["instantiations"]} if "instantiations" in k else {}),
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


# ---- every default Poseidon and Poseidon2 width (kernels 1, 2 and 3) ----

WIDTH_FIELDS = ("BLS12_381_FR", "BN254_FR", "BLS12_377_FR", "GOLDILOCKS_FR", "BABYBEAR_FR", "KOALABEAR_FR",
                "MERSENNE31_FR")
# (t, L) pairs of the default tables beyond rate 2 over the ~255-bit fields:
# kernels 1 and 2, and kernel 3's limb body
POSEIDON_WIDE_PAIRS = ((4, 11), (5, 11), (6, 11), (7, 11), (8, 11), (9, 11), (8, 3), (12, 3), (16, 2))
P2_WIDE_PAIRS = ((4, 11), (8, 11), (8, 3), (12, 3))
B_WIDTH = 1 << 14  # lanes of each default config through each kernel and its plain version
B_WIDTH_HOST = 1 << 12  # of them against host_permute_states
WIDTH_PATH_KERNELS = ("poseidon_permute_opt", "poseidon_permute_dense", "poseidon2_permute")


def default_configs(st):
    """[(label, config)]: every default parameter set of the Poseidon tables
    (constraints and weights) and the Poseidon2 table over the seven
    fields, at the rates 1-8 each table has."""
    out = []
    for fs in (getattr(st, name) for name in WIDTH_FIELDS):
        for rate in range(1, 9):
            for weights in (False, True):
                with contextlib.suppress(ValueError):
                    cfg = st.get_default_poseidon_parameters(fs, rate, weights)
                    out.append((f"Poseidon {fs.name} rate {rate} {'weights' if weights else 'constraints'}", cfg))
            with contextlib.suppress(ValueError):
                out.append((f"Poseidon2 {fs.name} rate {rate}", st.get_default_poseidon2_parameters(fs, rate)))
    return out


def widths_phase(st, dev, rng, gpu, kernels, rates, report):
    """Kernels 1, 2 and 3 at every default Poseidon and Poseidon2 width.
    Each default config (52 Poseidon, kernels 1 and 2; 14 Poseidon2, kernel
    3) on B_WIDTH lanes with 0, 1, p-1, p-2 in every element position and
    the near-bound lanes of all p-1 and all p-2: kernels 1 and 3 torch.equal
    to their plain versions, kernel 2 to kernel 1 (and to its own plain
    version on the first config of each (t, L)), 16 lanes to the oracle and
    B_WIDTH_HOST lanes to ``host_permute_states``.  Then per (t, L) pair
    beyond rate 2 over the ~255-bit fields (``POSEIDON_WIDE_PAIRS``,
    ``P2_WIDE_PAIRS``), the first config of that width (the constraints
    table; BLS12-381 at L = 11) at B_MAIN lanes, CUDA events, best of 3,
    beside its bound, with its census line (kernel 2's word pairs (8, 3),
    (12, 3) and (16, 2) through their word bodies).  Then the main path at full
    width, the launch counters zeroed just before it and read just after: a
    lazy and an eager PoseidonSponge at BLS12-381 rate 8 (t = 9) and
    Goldilocks rate 8 (t = 12) and a lazy Poseidon2 sponge at BLS12-381
    rate 7 (t = 8) on B_CHECK lanes, a compiled transcript at Goldilocks
    rate 8, sampled lanes against the oracle, and ``permute_dense`` at
    t = 9 (kernel 2, the parity tier) against kernel 1.  Returns the
    path's launch counts; each timed kernel's entry gains its rows under
    "instantiations"."""
    from sponge_tpu_torch.family import permutation_for
    from sponge_tpu_torch.fields import limbs_to_ints, mont_tensor_to_ints
    from sponge_tpu_torch.ops.montgomery import blocks_per_sm
    from sponge_tpu_torch.ops.poseidon_dense import body as dense_body
    from sponge_tpu_torch.ops.poseidon_dense import permute_dense
    from sponge_tpu_torch.ops.poseidon_opt import body as opt_body
    from sponge_tpu_torch.poseidon import host
    from sponge_tpu_torch.transcript import Absorb, SqueezeNative, compile_transcript

    start = time.perf_counter()
    configs = default_configs(st)
    n_p2 = sum(isinstance(cfg, st.Poseidon2Config) for _, cfg in configs)
    check((len(configs) - n_p2, n_p2) == (52, 14), f"default configs: {len(configs) - n_p2} Poseidon, {n_p2} Poseidon2")
    check(host.host_available(configs[0][1]), "the native host runtime did not build")
    plain_ms = {}
    for label, cfg in configs:
        fs, t, L = cfg.field, cfg.t, cfg.field.nlimbs
        names = ("poseidon2_permute",) if isinstance(cfg, st.Poseidon2Config) else (
            "poseidon_permute_opt", "poseidon_permute_dense")
        state = with_maxima(fs, with_edges(fs, random_plane(fs, (t, L, B_WIDTH), rng, dev)))
        outs = []
        for name in names:
            k = kernels[name]
            perm = permutation_for(cfg, dev)
            consts = perm.consts
            before = k["wrapper"].launches
            out_k = call_kernel(k, cfg, perm, state)
            torch.cuda.synchronize()
            check(k["wrapper"].launches == before + 1, f"{name}: the kernel was not launched at {label}")
            outs.append(out_k)
            if name == "poseidon_permute_dense" and (name, t, L) in plain_ms:
                continue  # kernel 2 == kernel 1 == plain below; its plain ran once at this (t, L)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out_p = k["plain"](cfg, consts, state)
            e1.record()
            torch.cuda.synchronize()
            plain_ms[(name, t, L)] = plain_ms.get((name, t, L)) or e0.elapsed_time(e1)
            err = int((out_k.long() - out_p.long()).abs().max())
            k["max_abs_err"] = max(k["max_abs_err"], err)
            check(torch.equal(out_k, out_p), f"{name} != plain at {label} (max err {err})")
        check(all(torch.equal(outs[0], o) for o in outs[1:]), f"kernel 1 != kernel 2 at {label}")
        sample = [0, 21, 42, 63, *NEAR_BOUND_LANES] + sorted(rng.choice(np.arange(66, B_WIDTH), 10, replace=False).tolist())
        check_lanes_vs_oracle(cfg, state, outs[0], sample, label)
        ins = mont_tensor_to_ints(fs, state[..., :B_WIDTH_HOST])
        want = mont_tensor_to_ints(fs, outs[0][..., :B_WIDTH_HOST])
        got = host.host_permute_states(cfg, [v for lane in zip(*ins) for v in lane])
        bad = [i // t for i, (a, b) in enumerate(zip(got, (v for lane in zip(*want) for v in lane))) if a != b]
        check(len(got) == t * B_WIDTH_HOST and not bad, f"{label}: host != card on lanes {bad[:8]}")
        say("widths", f"{label} (t, L) = ({t}, {L}): {' and '.join(names)} == plain at B={B_WIDTH} (kernel 2's plain "
            f"on the first config of each (t, L); edge lanes 0-63, "
            f"all p-1 and all p-2 in lanes {NEAR_BOUND_LANES[0]}-{NEAR_BOUND_LANES[1]})"
            f"{', kernel 1 == kernel 2' if len(names) > 1 else ''}; {len(sample)} lanes == oracle; "
            f"{B_WIDTH_HOST} lanes == host_permute_states")

    # one config per new pair at B_MAIN beside its bound, with its census line
    entries = ptxas_entries(report)
    first = {}
    for label, cfg in configs:
        first.setdefault((type(cfg), cfg.t, cfg.field.nlimbs), (label, cfg))
    timed = [(name, *first[(st.PoseidonConfig, t, L)]) for t, L in POSEIDON_WIDE_PAIRS
             for name in ("poseidon_permute_opt", "poseidon_permute_dense")]
    timed += [("poseidon2_permute", *first[(st.Poseidon2Config, t, L)]) for t, L in P2_WIDE_PAIRS]
    for name, label, cfg in timed:
        k, fs, t, L = kernels[name], cfg.field, cfg.t, cfg.field.nlimbs
        base, want, shared = census_instance(name, cfg)
        found = [v for key, v in entries.items() if f"{base}I" in key and template_args(key) == want]
        check(len(found) == 1, f"census: {len(found)} ptxas entries for {base} {want}")
        regs, spill_st, spill_ld = found[0]
        blocks = blocks_per_sm(regs, shared)
        say("census", f"{name} ({t}, {L}) at {label}: {regs} registers, spills {spill_st}/{spill_ld} B, "
            f"{shared:,} B of shared memory, {blocks} blocks per SM")
        big = with_maxima(fs, with_edges(fs, random_plane(fs, (t, L, B_MAIN), rng, dev)))
        perm = permutation_for(cfg, dev)
        ms, out = time_ms(lambda: call_kernel(k, cfg, perm, big))
        check_lanes_vs_oracle(cfg, big, out, [0, 63, *NEAR_BOUND_LANES, B_MAIN - 1], f"{name} {label} B=2^20")
        bound_ms, bound_by = kernel_bound(name, cfg, B_MAIN, rates)
        wide, narrow = limb_products(name, cfg)
        say("widths", f"{name} ({t}, {L}) at {label}, B={B_MAIN}: kernel {ms:.3f} ms = {B_MAIN / ms * 1e3:,.0f} "
            f"perms/s; bound {bound_ms:.3f} ms ({bound_by}, {bound_ms / ms:.1%} of it; {wide:,} wide + {narrow:,} "
            f"32-bit products per permutation); plain torch {plain_ms[(name, t, L)]:.1f} ms at B={B_WIDTH}; "
            f"5 lanes == oracle [{gpu}]")
        row = dict(t=t, L=L, config=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                   plain_ms=plain_ms[(name, t, L)], plain_batch=B_WIDTH, registers=regs, spill_store_bytes=spill_st,
                   spill_load_bytes=spill_ld, shared_bytes=shared, blocks_per_sm=blocks)
        row["body"] = dense_body(cfg) if name == "poseidon_permute_dense" else opt_body(cfg)
        k.setdefault("instantiations", []).append(row)
        del big, out

    # the main path at full width: sponges and a transcript at t = 9 and 12
    bls8 = st.get_default_poseidon_parameters(st.BLS12_381_FR, 8)
    gl8 = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8)
    p2_bls7 = st.get_default_poseidon2_parameters(st.BLS12_381_FR, 7)
    lane_vals = {id(cfg): random_plane(cfg.field, (cfg.rate + 3, cfg.field.nlimbs, B_CHECK), rng, dev)
                 for cfg in (bls8, gl8, p2_bls7)}
    parity_in = with_maxima(bls8.field, with_edges(bls8.field, random_plane(
        bls8.field, (bls8.t, bls8.field.nlimbs, B_CHECK), rng, dev)))
    steps = (Absorb(gl8.rate + 3), SqueezeNative(gl8.rate + 1), Absorb(2), SqueezeNative(3))
    tr_elems = random_plane(gl8.field, (gl8.rate + 5, gl8.field.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    by_body = kernels["poseidon_permute_opt"]["wrapper"].body_launches
    by_body.update(dict.fromkeys(by_body, 0))
    squeezed, by_pair = {}, {}
    for cfg in (bls8, gl8):
        fs = cfg.field
        before = kernels["poseidon_permute_opt"]["wrapper"].launches
        for lazy in (True, False):
            s = st.PoseidonSponge(cfg, batch_size=B_CHECK, lazy=lazy, device=dev)
            s.absorb(b"widths transcript")
            s.absorb([st.Fp(fs.modulus - 1, fs), st.Fp(0, fs)])
            s.absorb_element_plane(lane_vals[id(cfg)])
            squeezed[(id(cfg), lazy)] = (s.squeeze_native_field_elements(cfg.rate + 2), s.squeeze_bytes(40))
        by_pair[(cfg.t, fs.nlimbs)] = kernels["poseidon_permute_opt"]["wrapper"].launches - before
    p2_sponge = st.LazyPoseidonSponge(p2_bls7, batch_size=B_CHECK, device=dev)
    p2_sponge.absorb([st.Fp(p2_bls7.field.modulus - 2, p2_bls7.field)])
    p2_sponge.absorb_element_plane(lane_vals[id(p2_bls7)])
    p2_squeezed = p2_sponge.squeeze_native_field_elements(p2_bls7.rate + 2)
    tr_out = compile_transcript(gl8, steps)(tr_elems)
    perm8 = permutation_for(bls8, dev)
    parity = (st.batched_permute(bls8, parity_in), permute_dense(bls8, perm8.consts, parity_in, perm8.words))
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in WIDTH_PATH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the widths path")
    check(sum(by_body.values()) == launches["poseidon_permute_opt"] and by_body["two-word"] >= by_pair[(12, 3)] > 0
          and by_body["limb"] >= by_pair[(9, 11)] > 0, f"kernel 1's launches by body: {by_body}")
    say("launches", f"widths path: {json.dumps(launches)}; kernel 1 by (t, L): "
        + ", ".join(f"{pair} {n}" for pair, n in by_pair.items()) + f"; by body: {json.dumps(by_body)}")

    for cfg in (bls8, gl8):
        fs = cfg.field
        check(squeezed[(id(cfg), True)] == squeezed[(id(cfg), False)], f"{fs.name} t={cfg.t}: lazy != eager")
        native, sq_bytes = squeezed[(id(cfg), True)]
        vals = mont_tensor_to_ints(fs, lane_vals[id(cfg)])
        for b in list(range(4)) + [B_CHECK // 3, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
            o = st.OraclePoseidonSponge(cfg)
            o.absorb(b"widths transcript")
            o.absorb([st.Fp(fs.modulus - 1, fs), st.Fp(0, fs)])
            o.absorb_field_elements([row[b] for row in vals])
            check(native[b] == o.squeeze_native_field_elements(cfg.rate + 2), f"{fs.name} t={cfg.t} lane {b}: squeeze")
            check(sq_bytes[b] == o.squeeze_bytes(40), f"{fs.name} t={cfg.t} lane {b}: squeeze_bytes")
        say("sponge", f"lazy and eager PoseidonSponge {fs.name} rate {cfg.rate} (t={cfg.t}) B={B_CHECK}: equal; "
            f"native/bytes squeezes == oracle on 8 lanes")
    fs = p2_bls7.field
    vals = mont_tensor_to_ints(fs, lane_vals[id(p2_bls7)])
    for b in list(range(4)) + [B_CHECK // 3, B_CHECK - 1]:
        o = p2_bls7.oracle_sponge()
        o.absorb([st.Fp(fs.modulus - 2, fs)])
        o.absorb_field_elements([row[b] for row in vals])
        check(p2_squeezed[b] == o.squeeze_native_field_elements(p2_bls7.rate + 2), f"Poseidon2 t=8 lane {b}")
    say("sponge", f"lazy Poseidon2 sponge {fs.name} rate {p2_bls7.rate} (t={p2_bls7.t}) B={B_CHECK}: native "
        f"squeezes == oracle on 6 lanes")
    check(torch.equal(*parity), "t = 9: kernel 1 != kernel 2")
    check_lanes_vs_oracle(bls8, parity_in, parity[0], [0, 42, *NEAR_BOUND_LANES, B_CHECK - 1], "t = 9 parity")
    say("main", f"batched_permute {bls8.field.name} rate 8 (t={bls8.t}) at B={B_CHECK}: kernel 1 == kernel 2 (the parity "
        f"tier); 5 lanes == oracle, near-bound lanes among them")
    fs = gl8.field
    vals = mont_tensor_to_ints(fs, tr_elems)
    rows = [limbs_to_ints(fs, row) for row in tr_out.cpu().numpy()]
    for b in list(range(4)) + [B_CHECK // 5, B_CHECK - 1]:
        o = st.OraclePoseidonSponge(gl8)
        o.absorb_field_elements([row[b] for row in vals[: gl8.rate + 3]])
        want = o.squeeze_native_field_elements(gl8.rate + 1)
        o.absorb_field_elements([row[b] for row in vals[gl8.rate + 3 :]])
        want += o.squeeze_native_field_elements(3)
        check([row[b] for row in rows] == want, f"transcript {fs.name} t={gl8.t} lane {b}")
    say("sponge", f"compile_transcript {fs.name} rate {gl8.rate} (absorb {gl8.rate + 3}, squeeze {gl8.rate + 1}, "
        f"absorb 2, squeeze 3) at B={B_CHECK}: 6 lanes == oracle")
    say("widths", f"the widths phase took {time.perf_counter() - start:.1f} s")
    return {name: launches[name] for name in WIDTH_PATH_KERNELS}


# ---- every default Rescue-Prime, GMiMC, Griffin and Anemoi width (kernels 5, 8, 6 and 7) ----

FAMILY_KERNELS = ("rescue_permute", "gmimc_permute", "griffin_permute", "anemoi_permute")
FAMILY_GETTERS = ("get_default_rescue_parameters", "get_default_gmimc_parameters", "get_default_griffin_parameters",
                  "get_default_anemoi_parameters")
FAMILY_COUNTS = (56, 32, 11, 16)  # default configs over the seven fields at rates 1-8
# (t, L) of each kernel compiled before its wide schedules (the pairs beyond
# them are "new": 22 of kernel 5, 14 of kernel 8, 3 of kernel 6, 5 of kernel 7)
FAMILY_FIRST_PAIRS = {
    "rescue_permute": {(3, 11), (16, 2), (3, 2)},
    "gmimc_permute": {(3, 11), (8, 3), (3, 2)},
    "griffin_permute": {(3, 11), (8, 3), (3, 2)},
    "anemoi_permute": {(4, 11), (2, 11), (8, 3), (4, 2)},
}


def family_configs(st):
    """[(kernel name, label, config)]: every default Rescue-Prime, GMiMC,
    Griffin and Anemoi parameter set over the seven fields at rates 1-8."""
    out = []
    for name, getter in zip(FAMILY_KERNELS, FAMILY_GETTERS):
        for fs in (getattr(st, f) for f in WIDTH_FIELDS):
            for rate in range(1, 9):
                with contextlib.suppress(ValueError):
                    cfg = getattr(st, getter)(fs, rate)
                    out.append((name, f"{name.split('_')[0]} {fs.name} rate {rate}", cfg))
    return out


def family_widths_phase(st, dev, rng, gpu, kernels, rates, report):
    """Kernels 5, 8, 6 and 7 at every default width.  Each of the 115
    default configs on B_WIDTH_HOST lanes with 0, 1, p-1, p-2 in every
    element position and the near-bound lanes of all p-1 and all p-2: the
    kernel against ``host_permute_states`` on every lane and against the
    oracle on 16 lanes; on the first config of each (t, L) compiled since
    the wide schedules (44 pairs), torch.equal to the plain version on the
    same lanes.  Then each new pair at B_MAIN lanes, CUDA events, best of
    3, beside its bound, with its census line.  Then
    the main path at full width, the launch counters zeroed just before it
    and read just after: a lazy Rescue-Prime sponge at BLS12-381 rate 8
    (t = 9), an eager GMiMC sponge at BLS12-381 rate 8 (t = 9, the front
    reduction), a Griffin Goldilocks rate 8 (t = 12) Merkle root and an
    Anemoi compiled transcript at BLS12-381 rate 7 (t = 8), sampled lanes
    against the oracle.  Returns the path's launch counts; each timed
    kernel's entry gains its rows under "instantiations"."""
    from sponge_tpu_torch.family import permutation_for
    from sponge_tpu_torch.fields import limbs_to_ints, mont_tensor_to_ints
    from sponge_tpu_torch.hash import merkle_root
    from sponge_tpu_torch.ops.bounds import check_gmimc_bounds
    from sponge_tpu_torch.ops.montgomery import blocks_per_sm
    from sponge_tpu_torch.poseidon import host
    from sponge_tpu_torch.transcript import Absorb, SqueezeNative, compile_transcript

    start = time.perf_counter()
    configs = family_configs(st)
    counts = tuple(sum(name == n for n, *_ in configs) for name in FAMILY_KERNELS)
    check(counts == FAMILY_COUNTS, f"default family configs: {counts}, want {FAMILY_COUNTS}")

    def host_bad_lanes(cfg, ins, want):
        """Lanes where ``host_permute_states`` differs from the card's output
        (on half the cores: the plain versions' launches need one)."""
        t = cfg.t
        got = host.host_permute_states(cfg, [v for lane in zip(*ins) for v in lane],
                                       n_threads=max(1, (os.cpu_count() or 2) // 2))
        check(len(got) == t * B_WIDTH_HOST, f"host_permute_states returned {len(got)} values")
        return [i // t for i, (a, b) in enumerate(zip(got, (v for lane in zip(*want) for v in lane))) if a != b]

    # the host runtime's checks run on a worker thread (its native call
    # releases the GIL) while the card and the plain versions go on
    host_pool, host_jobs = ThreadPoolExecutor(1), []
    first = {}
    for name, label, cfg in configs:
        k, fs, t, L = kernels[name], cfg.field, cfg.t, cfg.field.nlimbs
        state = with_maxima(fs, with_edges(fs, random_plane(fs, (t, L, B_WIDTH_HOST), rng, dev)))
        perm = permutation_for(cfg, dev)
        consts = perm.consts
        before = k["wrapper"].launches
        out_k = call_kernel(k, cfg, perm, state)
        torch.cuda.synchronize()
        check(k["wrapper"].launches == before + 1, f"{name}: the kernel was not launched at {label}")
        sample = [0, 21, 42, 63, *NEAR_BOUND_LANES] + sorted(
            rng.choice(np.arange(66, B_WIDTH_HOST), 10, replace=False).tolist())
        check_lanes_vs_oracle(cfg, state, out_k, sample, label)
        ins, want = mont_tensor_to_ints(fs, state), mont_tensor_to_ints(fs, out_k)
        host_jobs.append((label, host_pool.submit(host_bad_lanes, cfg, ins, want)))
        extra = ""
        if (t, L) not in FAMILY_FIRST_PAIRS[name] and (name, t, L) not in first:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out_p = k["plain"](cfg, consts, state)
            e1.record()
            torch.cuda.synchronize()
            err = int((out_k.long() - out_p.long()).abs().max())
            k["max_abs_err"] = max(k["max_abs_err"], err)
            check(torch.equal(out_k, out_p), f"{name} != plain at {label} (max err {err})")
            first[(name, t, L)] = (label, cfg, e0.elapsed_time(e1))
            extra = f"; new pair: == plain on all {B_WIDTH_HOST} lanes"
        plan = f"; front reduction {'on' if check_gmimc_bounds(cfg).reduce else 'off'}" if (
            name == "gmimc_permute" and gmimc_body(cfg) == "limb") else ""
        say("widths", f"{label} (t, L) = ({t}, {L}): {name} at B={B_WIDTH_HOST} (edge lanes 0-63, all p-1 and "
            f"all p-2 in lanes {NEAR_BOUND_LANES[0]}-{NEAR_BOUND_LANES[1]}), {len(sample)} lanes == oracle{extra}{plan}")
    for label, job in host_jobs:
        bad = job.result()
        check(not bad, f"{label}: host != card on lanes {bad[:8]}")
    host_pool.shutdown()
    say("widths", f"all {len(host_jobs)} configs: the card's output == host_permute_states on all {B_WIDTH_HOST} "
        f"lanes")
    check(len(first) == 44, f"{len(first)} new (t, L) pairs, want 44")
    say("widths", f"{len(configs)} default Rescue-Prime, GMiMC, Griffin and Anemoi configs through their kernels, "
        f"none refused, none on the plain version; {len(first)} new (t, L) pairs == plain")

    # each new pair at B_MAIN beside its bound, with its census line
    entries = ptxas_entries(report)
    for (name, t, L), (label, cfg, plain_ms) in first.items():
        k, fs = kernels[name], cfg.field
        base, want, shared = census_instance(name, cfg)
        found = [v for key, v in entries.items() if f"{base}I" in key and template_args(key) == want]
        check(len(found) == 1, f"census: {len(found)} ptxas entries for {base} {want}")
        regs, spill_st, spill_ld = found[0]
        blocks = blocks_per_sm(regs, shared)
        say("census", f"{name} ({t}, {L}) at {label}: {base} {want}, {regs} registers, spills {spill_st}/{spill_ld} B, "
            f"{shared:,} B of shared memory, {blocks} blocks per SM")
        big = with_maxima(fs, with_edges(fs, random_plane(fs, (t, L, B_MAIN), rng, dev)))
        perm = permutation_for(cfg, dev)
        ms, out = time_ms(lambda: call_kernel(k, cfg, perm, big))
        check_lanes_vs_oracle(cfg, big, out, [0, 63, *NEAR_BOUND_LANES, B_MAIN - 1], f"{name} {label} B=2^20")
        bound_ms, bound_by = kernel_bound(name, cfg, B_MAIN, rates)
        wide, narrow = limb_products(name, cfg)
        say("widths", f"{name} ({t}, {L}) at {label}, B={B_MAIN}: kernel {ms:.3f} ms = {B_MAIN / ms * 1e3:,.0f} "
            f"perms/s; bound {bound_ms:.3f} ms ({bound_by}, {bound_ms / ms:.1%} of it; {wide:,} wide + {narrow:,} "
            f"32-bit products per permutation); plain torch {plain_ms:.1f} ms at B={B_WIDTH_HOST}; 5 lanes == "
            f"oracle [{gpu}]")
        k.setdefault("instantiations", []).append(dict(
            t=t, L=L, config=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
            plain_batch=B_WIDTH_HOST, registers=regs, spill_store_bytes=spill_st, spill_load_bytes=spill_ld,
            shared_bytes=shared, blocks_per_sm=blocks))
        del big, out

    # the main path at full width: sponges, a Merkle root and a transcript at t = 9, 9, 12 and 8
    bls = st.BLS12_381_FR
    r9, m9 = st.get_default_rescue_parameters(bls, 8), st.get_default_gmimc_parameters(bls, 8)
    g12, a8 = st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 8), st.get_default_anemoi_parameters(bls, 7)
    check(check_gmimc_bounds(m9).reduce, "GMiMC BLS12-381 t = 9 should take the front reduction")
    lane_vals = {id(cfg): random_plane(bls, (cfg.rate + 3, bls.nlimbs, B_CHECK), rng, dev) for cfg in (r9, m9)}
    g_leaves = random_plane(g12.field, (g12.field.nlimbs, B_LADDER_PLAIN), rng, dev)
    steps = (Absorb(a8.rate + 2), SqueezeNative(a8.rate + 1), Absorb(3), SqueezeNative(2))
    tr_elems = random_plane(bls, (a8.rate + 5, bls.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    squeezed = {}
    for cfg, lazy in ((r9, True), (m9, False)):
        s = st.PoseidonSponge(cfg, batch_size=B_CHECK, lazy=lazy, device=dev)
        s.absorb(b"family widths transcript")
        s.absorb([st.Fp(bls.modulus - 1, bls), st.Fp(0, bls)])
        s.absorb_element_plane(lane_vals[id(cfg)])
        squeezed[id(cfg)] = (s.squeeze_native_field_elements(cfg.rate + 2), s.squeeze_bytes(40))
    g_root = merkle_root(g12, g_leaves)
    tr_out = compile_transcript(a8, steps)(tr_elems)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in FAMILY_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the family widths path")
    say("launches", f"family widths path: {json.dumps(launches)}")

    for cfg, family in ((r9, "Rescue-Prime"), (m9, "GMiMC")):
        native, sq_bytes = squeezed[id(cfg)]
        vals = mont_tensor_to_ints(bls, lane_vals[id(cfg)])
        for b in list(range(4)) + [B_CHECK // 3, B_CHECK - 3, B_CHECK - 2, B_CHECK - 1]:
            o = cfg.oracle_sponge()
            o.absorb(b"family widths transcript")
            o.absorb([st.Fp(bls.modulus - 1, bls), st.Fp(0, bls)])
            o.absorb_field_elements([row[b] for row in vals])
            check(native[b] == o.squeeze_native_field_elements(cfg.rate + 2), f"{family} t={cfg.t} lane {b}: squeeze")
            check(sq_bytes[b] == o.squeeze_bytes(40), f"{family} t={cfg.t} lane {b}: squeeze_bytes")
        say("sponge", f"{'lazy' if cfg is r9 else 'eager'} {family} sponge {bls.name} rate {cfg.rate} (t={cfg.t}) "
            f"B={B_CHECK}: native/bytes squeezes == oracle on 8 lanes")
    check_merkle(g12, g_leaves, g_root, f"Griffin t={g12.t}")
    vals = mont_tensor_to_ints(bls, tr_elems)
    rows = [limbs_to_ints(bls, row) for row in tr_out.cpu().numpy()]
    for b in list(range(4)) + [B_CHECK // 5, B_CHECK - 1]:
        o = a8.oracle_sponge()
        o.absorb_field_elements([row[b] for row in vals[: a8.rate + 2]])
        want = o.squeeze_native_field_elements(a8.rate + 1)
        o.absorb_field_elements([row[b] for row in vals[a8.rate + 2 :]])
        want += o.squeeze_native_field_elements(2)
        check([row[b] for row in rows] == want, f"Anemoi transcript t={a8.t} lane {b}")
    say("sponge", f"compile_transcript Anemoi {bls.name} rate {a8.rate} (t={a8.t}; absorb {a8.rate + 2}, squeeze "
        f"{a8.rate + 1}, absorb 3, squeeze 2) at B={B_CHECK}: 6 lanes == oracle")
    say("widths", f"the family widths phase took {time.perf_counter() - start:.1f} s")
    return {name: launches[name] for name in FAMILY_KERNELS}


OVERWRITE_PHASE = "poseidon2_overwrite"  # its name for --only
OVERWRITE_LEAVES_LOG2, OVERWRITE_ROW = 23, 64  # the bb-mmcs-commit-2p23 cell's row set
P2_ROW3_MS = {"babybear_fr": 0.491, "koalabear_fr": 0.439}  # PERF.md's kernel table, row 3, at B = 2^20


def overwrite_phase(st, dev, rng, gpu):
    """Kernel 3's overwrite sponge (``ops/poseidon2.py``
    ``overwrite_permute_p2``) at the MMCS cell's sizes, launches counted:
    one commitment's row set (the 2^23 x 64 leaf set through
    ``padding_free_hash``, its truncated tree), with ``permute_p2.launches``
    zeroed just before and read just after (1 leaf launch, 23 tree
    launches); the digests against the plain backend (``permute_p2_plain``
    a chunk, run on the card a quarter of the lanes at a time), the unfused
    loop (``overwrite_rows`` and a plain-permutation launch a chunk) and the
    oracle, on random lanes and the near-bound lanes (lane 64 every element
    p - 1, lane 65 every element 0); every tree level against the plain
    backend's tree, and the first level, read from the digests' lane-stride-2
    views, against the ``cat`` of the children and the oracle; each timed
    beside its unfused loop, and the plain permutation at BabyBear and
    KoalaBear t = 16 at B = 2^20 beside the kernel table's times.  Returns
    the commitment's launches."""
    from sponge_tpu_torch.hash import merkle_tree_truncated, padding_free_hash, truncated_compress_pairs
    from sponge_tpu_torch.ops.poseidon2 import permute_p2
    from sponge_tpu_torch.poseidon.permutation import overwrite_rows, zero_state
    from sponge_tpu_torch.family import permutation_for

    cfg = st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8)
    fs, t, d, n = cfg.field, cfg.t, cfg.t // 2, 1 << OVERWRITE_LEAVES_LOG2
    consts = permutation_for(cfg, dev).consts
    leaves = random_plane(fs, (OVERWRITE_ROW, fs.nlimbs, n), rng, dev)
    for b, v in zip(NEAR_BOUND_LANES, (fs.modulus - 1, 0)):
        leaves[:, :, b] = torch.from_numpy(fs.ints_to_mont_plane([v])[:, 0]).to(dev)[None]

    def loop():
        state = zero_state(cfg, n, dev)
        for lo in range(0, OVERWRITE_ROW, cfg.rate):
            state = permute_p2(cfg, consts, overwrite_rows(cfg, state, leaves[lo : lo + cfg.rate]))
        return state[:d].clone()

    permute_p2.launches = 0
    digests = padding_free_hash(cfg, leaves, d)
    levels = merkle_tree_truncated(cfg, digests)
    torch.cuda.synchronize()
    launches = permute_p2.launches
    check(launches == 1 + OVERWRITE_LEAVES_LOG2, f"a commitment's row set took {launches} launches")
    say("launches", "overwrite sponge path (one commitment's row set: 1 leaf launch, "
        f"{OVERWRITE_LEAVES_LOG2} tree launches): " + json.dumps({"poseidon2_permute": launches}))

    quarter = n // 4
    for lo in range(0, n, quarter):
        plain = padding_free_hash(cfg, leaves[..., lo : lo + quarter], d, "plain")
        check(torch.equal(digests[..., lo : lo + quarter], plain),
              f"overwrite sponge != the plain backend on lanes [{lo}, {lo + quarter}) of the leaf set")
    del plain
    check(torch.equal(digests, loop()), "overwrite sponge != the unfused loop on the 2^23 x 64 leaf set")
    sample = list(range(16)) + list(NEAR_BOUND_LANES) + sorted(rng.choice(np.arange(66, n), 30, replace=False).tolist())
    for b in sample:
        o = cfg.oracle_sponge()
        o.state = [0] * t
        row = lane_ints(fs, leaves, b)
        for lo in range(0, OVERWRITE_ROW, cfg.rate):
            o.state = row[lo : lo + cfg.rate] + o.state[cfg.rate :]
            o.permute()
        check(lane_ints(fs, digests, b) == o.state[:d], f"overwrite sponge lane {b} differs from the oracle")
    say("overwrite", f"padding_free_hash {fs.name} t={t}: 2^{OVERWRITE_LEAVES_LOG2} rows of {OVERWRITE_ROW} in one "
        f"launch == the plain backend (torch.equal on the card, every lane) == the unfused loop (8 overwrites "
        f"and launches); {len(sample)} lanes == oracle, the near-bound lanes (every element p-1, every element 0) "
        f"among them")

    pairs = digests.reshape(d, fs.nlimbs, n // 2, 2)
    left, right = pairs[..., 0], pairs[..., 1]
    before = permute_p2.launches
    level = truncated_compress_pairs(cfg, left, right)
    check(permute_p2.launches == before + 1, "a tree level did not take one launch")
    check(torch.equal(level, levels[1]), "a tree level from lane-stride-2 views != the tree's first level")
    check(torch.equal(level, permute_p2(cfg, consts, torch.cat([left, right]))[:d]),
          "a tree level from lane-stride-2 views != the cat of its children")
    plain_levels = merkle_tree_truncated(cfg, digests, "plain")
    check(len(plain_levels) == len(levels) and all(torch.equal(a, b) for a, b in zip(levels, plain_levels)),
          "the truncated tree != the plain backend's tree")
    del plain_levels
    nodes = sorted({b // 2 for b in sample})  # the sampled lanes' parents
    for j in nodes:
        node = lane_ints(fs, level, j)
        o = cfg.oracle_sponge()
        o.state = lane_ints(fs, digests, 2 * j) + lane_ints(fs, digests, 2 * j + 1)
        o.permute()
        check(node == o.state[:d], f"tree node {j} differs from the oracle")
    say("overwrite", f"truncated_compress_pairs over 2^{OVERWRITE_LEAVES_LOG2 - 1} nodes read as lane-stride-2 "
        f"views == the cat of the children; all {OVERWRITE_LEAVES_LOG2} tree levels == the plain backend's tree "
        f"(torch.equal on the card); {len(nodes)} nodes == oracle")

    leaf_ms, _ = time_ms(lambda: padding_free_hash(cfg, leaves, d))
    loop_ms, _ = time_ms(loop)
    level_ms, _ = time_ms(lambda: truncated_compress_pairs(cfg, left, right))
    cat_ms, _ = time_ms(lambda: permute_p2(cfg, consts, torch.cat([left, right]))[:d].clone())
    say("time", f"overwrite sponge over 2^{OVERWRITE_LEAVES_LOG2} x {OVERWRITE_ROW}: {leaf_ms:.3f} ms "
        f"({n * OVERWRITE_ROW // cfg.rate / leaf_ms * 1e3:,.0f} perms/s), the unfused loop {loop_ms:.3f} ms; "
        f"a 2^{OVERWRITE_LEAVES_LOG2 - 1}-node level {level_ms:.3f} ms, with the cat {cat_ms:.3f} ms [{gpu}]")
    for other in (cfg, st.get_default_poseidon2_parameters(st.KOALABEAR_FR, 8)):
        state = random_plane(other.field, (other.t, other.field.nlimbs, B_MAIN), rng, dev)
        perm_consts = permutation_for(other, dev).consts
        ms, _ = time_ms(lambda: permute_p2(other, perm_consts, state))
        ref = P2_ROW3_MS[other.field.name]
        say("time", f"permute_p2 {other.field.name} t={other.t} B={B_MAIN}: {ms:.3f} ms, the kernel table's "
            f"{ref:.3f} ms ({ms / ref - 1:+.1%}) [{gpu}]")
    return {"poseidon2_permute": launches}


RPO_PHASE = "rescue_rpo"  # its name for --only
RPO_LEAVES_LOG2, RPO_ROW = 21, 71  # the gl-miden-commit-2p21 cell's row set
RESCUE_ROW5_MS = {"bls12_381_fr": 418.012, "goldilocks_fr": 10.180}  # PERF.md's kernel table, row 5, at B = 2^20


def rpo_phase(st, dev, rng, gpu, rates):
    """Kernel 5's MDS-first order (Rescue Prime Optimized, ``get_rpo_parameters``,
    Goldilocks (12, 3)) at the Miden cell's sizes, launches counted: the
    permutation at B = 2^20 with 0, 1, p-1, p-2 in every element position
    and the near-bound lanes (every element p-1, every element p-2)
    against its plain version (``torch.equal`` on the card) and the
    oracle; one commitment's row set (2^21 rows of 71 through
    ``rpo_hash_elements``, its merge tree ``merkle_tree_wide``) with
    ``rescue_permute.launches`` zeroed just before and read just after (9
    leaf launches, 21 tree launches), the digests and every level against
    the plain backend (every lane), sampled digests against the oracle's
    sponge, every launch counted as the two-word body's
    (``rescue_permute.body_launches``); the row set and the permutation
    timed, the permutation beside its bound; then kernel 5's Rescue-Prime
    rows (BLS12-381 t = 3, Goldilocks t = 12 at rate 8) at B = 2^20 beside
    the kernel table's times.  Returns the commitment's launches."""
    from sponge_tpu_torch.family import permutation_for
    from sponge_tpu_torch.hash import merkle_tree_wide, rpo_hash_elements
    from sponge_tpu_torch.ops.rescue import rescue_permute, rescue_permute_plain

    cfg = st.get_rpo_parameters(st.GOLDILOCKS_FR)
    fs, t, cap, d, n = cfg.field, cfg.t, cfg.capacity, 4, 1 << RPO_LEAVES_LOG2
    perm = permutation_for(cfg, dev)
    consts = perm.consts
    state = with_maxima(fs, with_edges(fs, random_plane(fs, (t, fs.nlimbs, B_MAIN), rng, dev)))
    out = perm.kernel(cfg, consts, state)
    check(torch.equal(out, rescue_permute_plain(cfg, consts, state)), "RPO kernel != plain at B=2^20")
    sample = list(range(66)) + sorted(rng.choice(np.arange(66, B_MAIN), 30, replace=False).tolist())
    check_lanes_vs_oracle(cfg, state, out, sample, "RPO kernel")
    say("rpo", f"rescue_permute RPO {fs.name} t={t} (MDS first, {cfg.rounds} rounds): torch.equal(kernel, plain) "
        f"at B={B_MAIN} incl. 64 edge lanes and the near-bound lanes; {len(sample)} lanes == oracle; "
        f"{rescue_plan_text(cfg)}")

    leaves = random_plane(fs, (RPO_ROW, fs.nlimbs, n), rng, dev)
    for b, v in zip(NEAR_BOUND_LANES, (fs.modulus - 1, fs.modulus - 2)):
        leaves[:, :, b] = torch.from_numpy(fs.ints_to_mont_plane([v])[:, 0]).to(dev)[None]
    rescue_permute.launches = 0
    rescue_permute.body_launches = dict.fromkeys(rescue_permute.body_launches, 0)
    digests = rpo_hash_elements(cfg, leaves, d)
    levels = merkle_tree_wide(cfg, digests)
    torch.cuda.synchronize()
    launches = rescue_permute.launches
    chunks = -(-RPO_ROW // cfg.rate)
    check(launches == chunks + RPO_LEAVES_LOG2, f"a commitment's row set took {launches} launches")
    check(rescue_permute.body_launches["two-word"] == launches,
          f"the row set's launches by body: {rescue_permute.body_launches}")
    say("launches", f"RPO commitment path (one row set: {chunks} leaf launches, {RPO_LEAVES_LOG2} tree "
        f"launches): " + json.dumps({"rescue_permute": launches, "by body": rescue_permute.body_launches}))
    half = n // 2
    for lo in range(0, n, half):
        plain = rpo_hash_elements(cfg, leaves[..., lo : lo + half], d, "plain")
        check(torch.equal(digests[..., lo : lo + half], plain),
              f"RPO leaf hash != the plain backend on lanes [{lo}, {lo + half})")
    del plain
    plain_levels = merkle_tree_wide(cfg, digests, "plain")
    check(len(plain_levels) == len(levels) and all(torch.equal(a, b) for a, b in zip(levels, plain_levels)),
          "the RPO merge tree != the plain backend's tree")
    del plain_levels
    rows = list(range(8)) + list(NEAR_BOUND_LANES) + sorted(rng.choice(np.arange(66, n), 20, replace=False).tolist())
    for b in rows:
        row = lane_ints(fs, leaves, b)
        o = cfg.oracle_sponge()
        o.state = [RPO_ROW % cfg.rate] + [0] * (t - 1)
        for lo in range(0, RPO_ROW, cfg.rate):
            chunk = row[lo : lo + cfg.rate]
            o.state = o.state[:cap] + chunk + [0] * (cfg.rate - len(chunk))
            o.permute()
        check(lane_ints(fs, digests, b) == o.state[cap : cap + d], f"RPO leaf hash lane {b} differs from the oracle")
    say("rpo", f"rpo_hash_elements over 2^{RPO_LEAVES_LOG2} rows of {RPO_ROW} and its merge tree == the plain "
        f"backend (torch.equal on the card, every lane and every level); {len(rows)} digests == the oracle's "
        f"sponge, the near-bound rows (every element p-1, every element p-2) among them")

    perm_ms, _ = time_ms(lambda: perm.kernel(cfg, consts, state))
    leaf_ms, _ = time_ms(lambda: rpo_hash_elements(cfg, leaves, d))
    tree_ms, _ = time_ms(lambda: merkle_tree_wide(cfg, digests))
    bound_ms, bound_by = kernel_bound("rescue_permute", cfg, B_MAIN, rates)
    wide, _ = limb_products("rescue_permute", cfg)
    say("time", f"rescue_permute RPO {fs.name} t={t} B={B_MAIN}: {perm_ms:.3f} ms "
        f"({perm_ms / B_MAIN * 1e6:.2f} ns a permutation); bound {bound_ms:.3f} ms ({bound_by}, "
        f"{bound_ms / perm_ms:.1%} of it; {wide:,} wide products per permutation); the row set's leaf hash "
        f"{leaf_ms:.3f} ms, its tree {tree_ms:.3f} ms [{gpu}]")
    for other in (st.get_default_rescue_parameters(st.BLS12_381_FR, 2),
                  st.get_default_rescue_parameters(st.GOLDILOCKS_FR, 8)):
        big = random_plane(other.field, (other.t, other.field.nlimbs, B_MAIN), rng, dev)
        other_perm = permutation_for(other, dev)
        ms, _ = time_ms(lambda: other_perm.kernel(other, other_perm.consts, big))
        ref = RESCUE_ROW5_MS[other.field.name]
        say("time", f"rescue_permute {other.field.name} t={other.t} B={B_MAIN}: {ms:.3f} ms, the kernel table's "
            f"{ref:.3f} ms ({ms / ref - 1:+.1%}) [{gpu}]")
    return {"rescue_permute": launches}


OCTTREE_PHASE = "poseidon_octtree"  # its name for --only
OCTTREE_CELL = "bls381-fil-tree-r-2p27"
OCTTREE_LEAVES_LOG2, OCTTREE_ARITY, OCTTREE_TAG = 27, 8, 255  # the cell's tree: 8^9 leaves, neptune's tag
OPT_ROW_9_MS = 64.952  # PERF.md's kernel table: kernel 1 at (9, 11), B = 2^20


def octtree_phase(st, dev, rng, gpu, rates):
    """Kernel 1's tagged step at (9, 11) at the Filecoin cell's size
    (``bls381-fil-tree-r-2p27``: an arity-8 tree over 2^27 BLS12-381
    leaves, neptune's tag 255 in the capacity), launches counted: one tree
    (``merkle_tree_arity``) with ``permute_opt.launches`` zeroed just before
    and read just after (9 launches, all the limb body's); at every level
    both ends and 64 drawn nodes (the leaf level's first node, whose 8
    children are all p-1, and its last, all p-2, among them) against the
    plain backend's ``compress_children`` over the same children on the
    card, the benchmark's reference (``spongebench/reference/octtree.py``)
    and the oracle's permutation of [255, c_0, ..., c_7]; the tree and a
    2^20-lane tagged step timed, the step beside its bound and kernel 1's
    untagged permutation at 2^20; then the cell's control, a harness run
    with the family's control config, which must read ``correct`` false.
    Returns the tree's launches."""
    from spongebench import harness
    from spongebench.reference.octtree import tagged_hash
    from spongebench.reference.poseidon import Poseidon
    from sponge_tpu_torch.family import permutation_for
    from sponge_tpu_torch.hash import compress_children, merkle_tree_arity
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt

    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 8)
    fs, k, tag, n = cfg.field, OCTTREE_ARITY, OCTTREE_TAG, 1 << OCTTREE_LEAVES_LOG2
    L, p = fs.nlimbs, fs.modulus
    ref = Poseidon.generate(p, cfg.rate, cfg.capacity, cfg.alpha, cfg.full_rounds, cfg.partial_rounds)
    leaves = random_plane(fs, (L, n), rng, dev)
    for lo, v in ((0, p - 1), (n - k, p - 2)):
        leaves[:, lo : lo + k] = torch.from_numpy(fs.ints_to_mont_plane([v])).to(dev)
    permute_opt.launches = 0
    permute_opt.body_launches = dict.fromkeys(permute_opt.body_launches, 0)
    levels = merkle_tree_arity(cfg, leaves, k, tag)
    torch.cuda.synchronize()
    launches = permute_opt.launches
    depth = OCTTREE_LEAVES_LOG2 // 3
    check(launches == depth and permute_opt.body_launches["limb"] == depth,
          f"the tree took {launches} launches, by body {permute_opt.body_launches}")
    say("launches", f"Filecoin tree_r_last base tree (2^{OCTTREE_LEAVES_LOG2} leaves, arity {k}, {depth} levels): "
        + json.dumps({"poseidon_permute_opt": launches, "by body": permute_opt.body_launches}))
    checked = 0
    for i in range(1, len(levels)):
        m = levels[i].shape[-1]
        drawn = rng.choice(m, min(64, m), replace=False).tolist()
        idx = torch.tensor(sorted({0, m - 1, *drawn}), device=dev)
        kids = levels[i - 1].index_select(-1, (idx[:, None] * k + torch.arange(k, device=dev)).reshape(-1))
        kids = kids.reshape(L, -1, k).permute(2, 0, 1)
        got = levels[i].index_select(-1, idx)
        check(torch.equal(got, compress_children(cfg, kids, tag, "plain")),
              f"level {i}: the kernel's nodes != the plain backend's")
        for j in range(idx.numel()):
            children = lane_ints(fs, kids, j)
            node = lane_ints(fs, got[None], j)[0]
            check(node == tagged_hash(ref, tag, children) == oracle_permute(cfg, [tag] + children)[1],
                  f"level {i} node {int(idx[j])} differs from the reference or the oracle")
        checked += idx.numel()
    check(lane_ints(fs, leaves[None], 0)[0] == p - 1 and lane_ints(fs, leaves[None], n - 1)[0] == p - 2,
          "the near-bound leaves")
    say("octtree", f"merkle_tree_arity over 2^{OCTTREE_LEAVES_LOG2} leaves (tag {tag}): {checked} nodes of all "
        f"{depth} levels == the plain backend on the card, the reference's tagged hash and the oracle, the "
        f"leaf level's all-(p-1) and all-(p-2) nodes among them")

    tree_ms, _ = time_ms(lambda: merkle_tree_arity(cfg, leaves, k, tag))
    lanes = min(B_MAIN, n // k)
    step = leaves[:, : k * lanes].reshape(L, lanes, k).permute(2, 0, 1)
    step_ms, _ = time_ms(lambda: compress_children(cfg, step, tag))
    perm = permutation_for(cfg, dev)
    state = random_plane(fs, (cfg.t, L, lanes), rng, dev)
    perm_ms, _ = time_ms(lambda: perm.kernel(cfg, perm.consts, state))
    bound_ms, bound_by = kernel_bound("poseidon_permute_opt", cfg, lanes, rates)
    say("time", f"Filecoin tree over 2^{OCTTREE_LEAVES_LOG2} leaves: {tree_ms:.3f} ms "
        f"({n / tree_ms * 1e3 / 1e6:.2f} M leaves/s, {tree_ms / ((n - 1) // (k - 1)) * 1e6:.2f} ns a node); "
        f"the tagged step over {lanes} lanes of 8 strided children {step_ms:.3f} ms, kernel 1's permutation "
        f"at (9, 11) B={lanes} {perm_ms:.3f} ms (the kernel table's {OPT_ROW_9_MS:.3f} ms at 2^20, "
        f"{perm_ms / OPT_ROW_9_MS - 1:+.1%}); bound {bound_ms:.3f} ms ({bound_by}; the step at "
        f"{bound_ms / step_ms:.1%} of it) [{gpu}]")
    del levels, leaves, step, state
    torch.cuda.empty_cache()

    cell = harness.resolve(OCTTREE_CELL)
    out = harness.run(cell, SEED, 0, False, "cuda", time.perf_counter(), control=True)
    bad = out["checks"]["node_mismatches"]["value"]
    check(out["correct"] is False and bad > 0, f"the cell's control read correct {out['correct']}")
    say("octtree", f"{OCTTREE_CELL}'s control (R_P - 1): correct false, {bad} node mismatches")
    torch.cuda.empty_cache()
    return {"poseidon_permute_opt": launches}


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
            o = cfg.oracle_sponge()
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
            o = cfg.oracle_sponge()
            o.absorb_field_elements(level[i] + level[i + 1])
            nxt.append(o.squeeze_native_field_elements(d))
        level = nxt
    got = mont_tensor_to_ints(fs, merkle_root_wide(cfg, small)[..., None])
    check([v[0] for v in got] == level[0], "wide 2^10 Merkle root != oracle")
    n = f"2^{leaves.shape[-1].bit_length() - 1}"
    say("merkle", f"wide-digest (d = {d}) {fs.name} t={cfg.t} root over {n} leaves: kernel == plain; root over "
        f"2^10 leaves == oracle")


SHARDED_PATH_KERNELS = ("poseidon_permute_opt", "monolith_permute", "griffin_permute", "anemoi_permute")
B_TREE = 1 << 24  # BASELINE.json's Merkle workload
K_PROOFS = 1 << 14
CHECKPOINT_DEPTH = 10


def jive_oracle(cfg, vals):
    """One Jive_2 node by the oracle permutation: vals = left ‖ right."""
    out, d, p = oracle_permute(cfg, vals), cfg.t // 2, cfg.field.modulus
    return [(vals[j] + vals[d + j] + out[j] + out[d + j]) % p for j in range(d)]


def check_jive_levels(cfg, levels, rng, what):
    """Nodes at both ends and two random ones of every level == the oracle
    replay of their two children (the top level is the root)."""
    fs = cfg.field
    for i in range(1, len(levels)):
        n = levels[i].shape[-1]
        for j in sorted({0, n - 1, int(rng.integers(n)), int(rng.integers(n))}):
            kids = lane_ints(fs, levels[i - 1], 2 * j) + lane_ints(fs, levels[i - 1], 2 * j + 1)
            check(lane_ints(fs, levels[i], j) == jive_oracle(cfg, kids), f"{what}: level {i} node {j} != oracle")


def sharded_phase(st, dev, rng, gpu, kernels, bls, mo_gl, g_gl, a_bls1):
    """The data-parallel layer in a world-size-1 NCCL group, Jive-mode trees
    and checkpoints.  Zeroes the launch counters, drives the path, reads the
    counters (kernels 1, 4, 6 and 7 must have run), then checks every result
    against the unsharded functions, the plain versions and the oracle, and
    times the path: the sharded 2^24-leaf root, the 2^20-leaf Jive roots,
    the scaling report, a profiler trace of the sharded root with its busy
    share, and the torchrun CLI.  Returns the path's launch counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from sponge_tpu_torch import checkpoint as ck
    from sponge_tpu_torch import hash as h
    from sponge_tpu_torch.parallel import (
        multihost,
        sharded_merkle_root,
        sharded_merkle_root_jive,
        sharded_merkle_root_wide,
        sharded_merkle_verify_batch,
        sharded_permute_fn,
        sharded_transcript_fn,
    )
    from sponge_tpu_torch.transcript import Absorb, SqueezeNative
    from sponge_tpu_torch.utils import profiling

    fs, gl = bls.field, g_gl.field
    multihost.initialize()  # no launcher: a world-size-1 NCCL group on cuda:0
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "not a world-size-1 NCCL group")
    mesh = multihost.global_mesh()
    say("sharded", f"process group: backend {dist.get_backend()}, world size 1, mesh {mesh}")
    state = with_edges(fs, random_plane(fs, (bls.t, fs.nlimbs, B_MAIN), rng, dev))
    steps = (Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(3))
    elems = random_plane(fs, (4, fs.nlimbs, B_CHECK), rng, dev)
    leaves = random_plane(fs, (fs.nlimbs, B_TREE), rng, dev)
    levels = h.merkle_tree(bls, leaves)  # the unsharded reference
    root = levels[-1][:, 0]
    idx = torch.from_numpy(np.concatenate([[0, B_TREE - 1], rng.choice(B_TREE, K_PROOFS - 2, replace=False)]))
    paths = h.merkle_open_batch(levels, idx)
    proof_leaves = leaves[:, idx.to(dev)].clone()
    proof_leaves[:, 77] = leaves[:, int(idx[78])]  # a canonical leaf that is not this proof's
    d = h.default_digest_elems(mo_gl)
    wide = random_plane(gl, (d, gl.nlimbs, B_MAIN), rng, dev)
    a_leaves = random_plane(a_bls1.field, (a_bls1.t // 2, a_bls1.field.nlimbs, B_MAIN), rng, dev)
    g_leaves = random_plane(gl, (g_gl.t // 2, gl.nlimbs, B_MAIN), rng, dev)
    g_idx = torch.from_numpy(np.concatenate([[0, B_MAIN - 1], rng.choice(B_MAIN, K_PROOFS - 2, replace=False)]))
    sponge_vals = random_plane(fs, (3, fs.nlimbs, B_CHECK), rng, dev)
    work = pathlib.Path(__file__).resolve().parent / "build"
    work.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=work))

    for k in kernels.values():
        k["wrapper"].launches = 0
    sh_out = sharded_permute_fn(bls, mesh)(state)
    sh_tr = sharded_transcript_fn(bls, steps, mesh)(elems)
    sh_root = sharded_merkle_root(bls, leaves, mesh)
    sh_ok = sharded_merkle_verify_batch(bls, root, proof_leaves, paths, idx, mesh)
    sh_wide = sharded_merkle_root_wide(mo_gl, wide, mesh)
    a_levels = h.merkle_tree_jive(a_bls1, a_leaves)
    g_levels = h.merkle_tree_jive(g_gl, g_leaves)
    g_paths = h.merkle_open_batch_wide(g_levels, g_idx)
    g_bad = g_paths.clone()
    g_bad[5, :, :, 11] = g_leaves[..., 0]
    g_ok = h.merkle_verify_batch_jive(g_gl, g_levels[-1][..., 0], g_leaves[..., g_idx.to(dev)], g_paths, g_idx)
    g_refused = h.merkle_verify_batch_jive(g_gl, g_levels[-1][..., 0], g_leaves[..., g_idx.to(dev)], g_bad, g_idx)
    sh_jive = sharded_merkle_root_jive(g_gl, g_leaves, mesh)
    ck.save_merkle_level(tmp / "level.npz", bls, levels[CHECKPOINT_DEPTH], CHECKPOINT_DEPTH)
    level, depth = ck.load_merkle_level(tmp / "level.npz", bls, device=dev)
    resumed_root = h.merkle_root(bls, level)
    sponge = st.PoseidonSponge(bls, batch_size=B_CHECK, device=dev)
    sponge.absorb(b"checkpointed transcript")
    sponge.absorb_element_plane(sponge_vals[:2])
    sponge.squeeze_native_field_elements(1)
    sponge.absorb_element_plane(sponge_vals[2:])
    ck.save_sponge(tmp / "sponge.npz", sponge)
    loaded = ck.load_sponge(tmp / "sponge.npz", bls, device=dev)
    want_sq, got_sq = sponge.squeeze_native_field_elements(4), loaded.squeeze_native_field_elements(4)
    report = multihost.scaling_report(bls, B_MAIN)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in SHARDED_PATH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the sharded/Jive/checkpoint path")
    say("launches", "sharded/Jive/checkpoint path: " + json.dumps(launches))

    check(torch.equal(sh_out, st.batched_permute(bls, state)), "sharded_permute_fn != batched_permute")
    check(torch.equal(sh_tr, st.compile_transcript(bls, steps)(elems)), "sharded_transcript_fn != compile_transcript")
    say("sharded", f"sharded_permute_fn {fs.name} rate 2 at B=2^20 == batched_permute; sharded_transcript_fn "
        f"(absorb 3, squeeze 2, absorb 1, squeeze 3) at 2^16 lanes == compile_transcript")
    check(torch.equal(sh_root, root), "sharded_merkle_root over 2^24 leaves != merkle_root")
    check(not bool(sh_ok[77]) and bool(sh_ok[:77].all()) and bool(sh_ok[78:].all()),
          "sharded_merkle_verify_batch: only the tampered proof must fail")
    check(depth == CHECKPOINT_DEPTH and torch.equal(level, levels[CHECKPOINT_DEPTH])
          and torch.equal(resumed_root, root), "Merkle level checkpoint: resume != root")
    say("sharded", f"sharded_merkle_root over 2^24 {fs.name} leaves (738 MB) == merkle_root; "
        f"sharded_merkle_verify_batch: {K_PROOFS} proofs (leaves 0 and 2^24-1 among them) verify, the tampered one "
        f"fails alone; level {CHECKPOINT_DEPTH} saved, loaded and resumed to the same root")
    check(torch.equal(sh_wide, h.merkle_root_wide(mo_gl, wide)), "sharded_merkle_root_wide != merkle_root_wide")
    say("sharded", f"sharded_merkle_root_wide Monolith {gl.name} t={mo_gl.t} d={d} over 2^20 leaves == "
        f"merkle_root_wide")
    check(want_sq == got_sq, "sponge checkpoint: the loaded sponge squeezes differently")
    say("checkpoint", f"PoseidonSponge B={B_CHECK} saved mid-transcript ({loaded.mode}, index {loaded.index}), "
        f"loaded on the card: the same 4 squeezes on every lane")

    check(torch.equal(sh_jive, g_levels[-1][..., 0]), "sharded_merkle_root_jive != merkle_root_jive")
    check(bool(g_ok.all()), f"Jive proofs: {int((~g_ok).sum())} failed")
    check(not bool(g_refused[11]) and bool(g_refused[:11].all()) and bool(g_refused[12:].all()),
          "a tampered Jive proof: only its own lane must fail")
    for cfg, lv, what in ((a_bls1, a_levels, "Anemoi"), (g_gl, g_levels, "Griffin")):
        check_jive_levels(cfg, lv, rng, f"{what} Jive tree")
    sub = 1 << 10
    check(torch.equal(h.merkle_root_jive(g_gl, g_leaves[..., :sub], backend="plain"), g_levels[10][..., 0]),
          "Griffin Jive root over 2^10 leaves: kernel != plain")
    say("jive", f"merkle_tree_jive Anemoi {fs.name} t={a_bls1.t} and Griffin {gl.name} t={g_gl.t} (d = 4) over "
        f"2^20 leaves: 4 nodes of every level == oracle (the roots included); Griffin 2^10-leaf subtree root == "
        f"plain; {K_PROOFS} Griffin proofs verify, one tampered fails alone; sharded_merkle_root_jive == "
        f"merkle_root_jive")
    for cfg in (a_bls1, g_gl):
        cf = cfg.field
        x = with_edges(cf, random_plane(cf, (cfg.t, cf.nlimbs, K_PROOFS), rng, dev))
        half = cfg.t // 2
        got = h.jive_compress_pairs(cfg, x[:half], x[half:])
        plain = h.jive_compress_pairs(cfg, x[:half], x[half:], backend="plain")
        check(torch.equal(got, plain), f"jive_compress_pairs {cf.name} t={cfg.t}: kernel != plain")
        for b in (0, 1, 2, 63, K_PROOFS - 1):
            check(lane_ints(cf, got, b) == jive_oracle(cfg, lane_ints(cf, x, b)), f"Jive node {b} != oracle")
        say("jive", f"jive_compress_pairs {cf.name} t={cfg.t}: torch.equal(kernel, plain) on {K_PROOFS} lanes incl. "
            f"64 edge lanes (0, 1, p-1, p-2); 5 nodes == oracle permutation + the four-term sum")

    check(report["devices"] == 1 and report["perms_per_sec"] > 0, f"scaling_report: {report}")
    say("time", f"scaling_report (parity-gated) world size 1, 2^20 lanes: {report['perms_per_sec']:,.0f} perms/s "
        f"per device [{gpu}]")
    for what, fn in (
        ("sharded_merkle_root 2^24 BLS12-381 leaves", lambda: sharded_merkle_root(bls, leaves, mesh)),
        ("merkle_root 2^24 BLS12-381 leaves (unsharded)", lambda: h.merkle_root(bls, leaves)),
        (f"merkle_root_jive Anemoi t={a_bls1.t} 2^20 leaves", lambda: h.merkle_root_jive(a_bls1, a_leaves)),
        (f"merkle_root_jive Griffin {gl.name} t={g_gl.t} 2^20 leaves", lambda: h.merkle_root_jive(g_gl, g_leaves)),
        (f"sharded_merkle_root_jive Griffin {gl.name} 2^20 leaves",
         lambda: sharded_merkle_root_jive(g_gl, g_leaves, mesh)),
    ):
        ms, _ = time_ms(fn, reps=2)
        say("time", f"{what}: {ms:.3f} ms [{gpu}]")

    with profiling.trace(tmp / "trace"):
        with profiling.annotate("sharded_merkle_root_2^24"):
            traced = sharded_merkle_root(bls, leaves, mesh)
    check(torch.equal(traced, root), "traced sharded root != merkle_root")
    busy = profiling.device_busy_share(tmp / "trace")
    names = ", ".join(f"{n.split('(')[0].split('<')[0].replace('void ', '')} {us / 1e3:.3f} ms"
                      for n, us in sorted(busy["kernels"].items(), key=lambda kv: -kv[1])[:4])
    check(any("poseidon_opt_kernel" in n for n in busy["kernels"]), "kernel 1 is not among the trace's CUDA kernels")
    say("trace", f"sharded_merkle_root 2^24 under torch.profiler: device busy {busy['busy_share'] * 100:.1f}% of "
        f"{busy['window_us'] / 1e3:.3f} ms ({busy['kernel_us'] / 1e3:.3f} ms in kernels); top kernels: {names} [{gpu}]")

    cli = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
         "-m", "sponge_tpu_torch.parallel.multihost", "--batch-per-device", str(B_MAIN)],
        capture_output=True, text=True, timeout=300, cwd=pathlib.Path(__file__).resolve().parent,
    )
    check(cli.returncode == 0, f"torchrun multihost CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    cli_report = json.loads(cli.stdout.strip().splitlines()[-1])
    check(cli_report["devices"] == 1 and cli_report["perms_per_sec"] > 0, f"CLI report {cli_report}")
    say("time", f"torchrun --nproc-per-node=1 -m sponge_tpu_torch.parallel.multihost (2^20 lanes): "
        f"{cli_report['perms_per_sec']:,.0f} perms/s [{gpu}]")
    dist.destroy_process_group()
    shutil.rmtree(tmp)
    return launches


HOST_PATH_KERNELS = ("poseidon_permute_opt", "poseidon2_permute", "rescue_permute", "monolith_permute",
                     "griffin_permute", "anemoi_permute", "gmimc_permute")
B_HOST = 1 << 16  # states per family through the host runtime and the card
FS_LANES = 1 << 20  # Fiat-Shamir transcripts on the card
FS_VERIFY = 4096  # of them verified on the host, half from each end
MERKLE_PROOFS = 1 << 14
MEDIAN_REPS = 1000


def cpu_model() -> str:
    """The host CPU's model (``/proc/cpuinfo``) and its logical CPU count."""
    found = re.search(r"^model name\s*:\s*(.+)$", pathlib.Path("/proc/cpuinfo").read_text(), re.M)
    return f"{found.group(1).strip() if found else 'not reported'} x {os.cpu_count()}"


def median_us(fn, reps=MEDIAN_REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def run_example(main, **kwargs):
    """Call an example's ``main`` and return (its result, its printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(**kwargs)
    return result, buf.getvalue().splitlines()


def host_phase(st, dev, rng, gpu, kernels):
    """The verifier's side and the examples.  Refuses a missing native
    library (no hidden fallback to the oracle), zeroes the launch counters,
    drives the Fiat-Shamir example at 2^20 transcripts, the Merkle example
    at 2^20 Goldilocks leaves with 2^14 proofs, the family tour, every tour
    config's permutation at 2^16 states and a random schedule of the lazy
    sponge, and reads the counters (kernels 1 and 3-8 must have run).  Then
    it checks the card against the host runtime (4,096 transcripts, every
    lane of the 2^16 states per family), the native codec against the pure
    path, and the tracer against the card's lane, and times the host side
    beside the card.  Returns the path's launch counts."""
    import shutil
    import tempfile

    from sponge_tpu_torch.examples import family_tour, fiat_shamir, merkle_commitment
    from sponge_tpu_torch.fields import ints_to_limbs, limbs_to_ints
    from sponge_tpu_torch.ops import montgomery as mont
    from sponge_tpu_torch.poseidon import host
    from sponge_tpu_torch.tracer import ConstraintSystem, FpVar, PoseidonSpongeVar
    from sponge_tpu_torch.transcript import compile_transcript
    from sponge_tpu_torch.utils import native, profiling

    where = f"[{gpu}; host {cpu_model()}]"
    tour = family_tour.configs()
    t0 = time.perf_counter()
    check(native.get_poseidon_lib() is not None, "the native host runtime did not build (no C++ compiler?)")
    check(native.get_lib() is not None, "the native codec did not build")
    for name, cfg in tour:
        check(host.host_available(cfg), f"host runtime unavailable for {name}")
    say("host", f"native host runtime and codec built with the system C++ compiler in "
        f"{time.perf_counter() - t0:.1f} s; host_available for all {len(tour)} tour configs")

    bls = tour[0][1]
    fs = bls.field
    states = {name: with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_HOST), rng, dev))
              for name, cfg in tour}
    steps, k_abs = [], 0
    for i in range(10):
        n = int(rng.integers(1, 6))
        steps.append(("absorb" if i % 2 == 0 else "squeeze", n))
        k_abs += n if i % 2 == 0 else 0
    sponge_elems = random_plane(fs, (k_abs, fs.nlimbs, B_CHECK), rng, dev)

    for k in kernels.values():
        k["wrapper"].launches = 0
    (msgs, fs_elems, challenges), fs_lines = run_example(fiat_shamir.main, device=dev, lanes=FS_LANES)
    root, mk_lines = run_example(merkle_commitment.main, device=dev, lanes=B_MAIN, proofs=MERKLE_PROOFS)
    tour_out, tour_lines = run_example(family_tour.main, device=dev)
    outs = {name: st.batched_permute(cfg, states[name]) for name, cfg in tour}
    sponge = st.PoseidonSponge(bls, batch_size=B_CHECK, device=dev)
    squeezed, pos = [], 0
    for kind, n in steps:
        if kind == "absorb":
            sponge.absorb_element_plane(sponge_elems[pos : pos + n])
            pos += n
        else:
            squeezed.append(sponge.squeeze_native_plane(n))
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in HOST_PATH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the host runtime/tracer/examples path")
    say("launches", "host runtime/tracer/examples path: " + json.dumps(launches))

    # the examples printed their load-bearing lines (each after its own check)
    for lines, want in ((fs_lines, "challenges match the device transcript lane"),
                        (mk_lines, f"opened+verified {MERKLE_PROOFS} proofs"),
                        *((tour_lines, f"{name}: challenge=") for name, _ in tour)):
        check(any(want in line for line in lines), f"an example did not print {want!r}")
    for line in fs_lines + mk_lines + tour_lines:
        say("example", line.strip())

    # Fiat-Shamir: the codec against the pure path, then 4,096 transcripts on the host
    sample = [int(v) for v in msgs[:, : 1 << 12].reshape(-1)]  # 2^14 of the absorbed values
    plane = fs.ints_to_mont_plane(sample)
    check(np.array_equal(plane, ints_to_limbs(fs, [fs.to_mont(x) for x in sample])), "native encode != pure")
    check(fs.mont_plane_to_ints(plane) == sample, "native decode != pure")
    lanes = np.concatenate([np.arange(FS_VERIFY // 2), np.arange(FS_LANES - FS_VERIFY // 2, FS_LANES)])
    sel = torch.from_numpy(lanes).to(dev)
    card = list(zip(*(limbs_to_ints(fs, row.index_select(-1, sel).cpu().numpy()) for row in challenges)))
    for j, b in enumerate(lanes):
        got, _ = host.host_run_schedule(bls, fiat_shamir.STEPS, [int(v) for v in msgs[:, b]])
        check(got == list(card[j]), f"Fiat-Shamir lane {b}: host {got} != card {card[j]}")
    for j in list(range(8)) + list(range(FS_VERIFY - 8, FS_VERIFY)):
        want = fiat_shamir.oracle_challenges(bls, [int(v) for v in msgs[:, lanes[j]]])
        check(want == list(card[j]), f"Fiat-Shamir lane {lanes[j]}: oracle != card")
    say("host", f"Fiat-Shamir {fs.name} rate 2 (absorb 3, squeeze 2, absorb 1, squeeze 1) at B={FS_LANES} on the "
        f"card: {FS_VERIFY} lanes ({FS_VERIFY // 2} from each end) == host_run_schedule, 16 == oracle; the native "
        f"codec == the pure path on {len(sample)} absorbed values")

    # every tour config: the host runtime on all 2^16 states against the card
    for name, cfg in tour:
        cf = cfg.field
        ins = [limbs_to_ints(cf, row) for row in mont.from_mont(cf, states[name]).int().cpu().numpy()]
        want = [limbs_to_ints(cf, row) for row in mont.from_mont(cf, outs[name]).int().cpu().numpy()]
        got = host.host_permute_states(cfg, [v for lane in zip(*ins) for v in lane])
        flat_want = [v for lane in zip(*want) for v in lane]
        bad = [i // cfg.t for i, (a, b) in enumerate(zip(got, flat_want)) if a != b]
        check(len(got) == len(flat_want) and not bad, f"{name}: host != card on lanes {bad[:8]}")
        say("host", f"{name} t={cfg.t}: host_permute_states == batched_permute on the card on all {B_HOST} "
            f"lanes (lanes 0-63 hold 0, 1, p-1, p-2 in every element position)")

    # the tracer against the card: one lane of the random schedule
    lane = int(rng.integers(0, B_CHECK))
    lane_vals = limbs_to_ints(fs, mont.from_mont(fs, sponge_elems[..., lane : lane + 1]).int()[..., 0].cpu().numpy().T)
    cs = ConstraintSystem(fs)
    var = PoseidonSpongeVar(cs, bls)
    traced, pos = [], 0
    for kind, n in steps:
        if kind == "absorb":
            var.absorb([FpVar.new_witness(cs, v) for v in lane_vals[pos : pos + n]])
            pos += n
        else:
            traced.append([e.value for e in var.squeeze_field_elements(n)])
    on_card = [limbs_to_ints(fs, sq[..., lane].cpu().numpy().T) for sq in squeezed]
    check(traced == on_card, f"tracer lane {lane}: {traced} != card {on_card}")
    check(cs.is_satisfied(), "the traced constraint system is not satisfied")
    cs1 = ConstraintSystem(fs)
    one = PoseidonSpongeVar(cs1, bls)
    one.state = [FpVar.new_witness(cs1, v) for v in lane_vals[: bls.t]]
    one.permute()
    per_perm = 5 * (bls.full_rounds * bls.t + bls.partial_rounds)
    check(cs1.num_constraints == per_perm == 275, f"one permutation costs {cs1.num_constraints} constraints")
    check([e.value for e in one.state] == oracle_permute(bls, lane_vals[: bls.t]), "traced permutation != oracle")
    say("tracer", f"PoseidonSpongeVar over a random schedule ({', '.join(f'{k} {n}' for k, n in steps)}) on lane "
        f"{lane}: squeezed witness values == the card's PoseidonSponge lane of B={B_CHECK}; "
        f"{cs.num_constraints} constraints, {cs.num_witness_variables} witnesses, satisfied; one permutation "
        f"= {cs1.num_constraints} constraints (5 * (R_F * t + R_P))")

    # timings: where a verifier should stay on the host and where it should batch onto the card
    hs, o = st.HostPoseidonSponge(bls), st.OraclePoseidonSponge(bls)
    hs.state = o.state = list(lane_vals[: bls.t])
    host_us, oracle_us = median_us(hs.permute), median_us(o.permute)
    say("host", f"one {fs.name} rate-2 permutation: HostPoseidonSponge.permute {host_us:.2f} us, "
        f"OraclePoseidonSponge.permute {oracle_us:.1f} us (median of {MEDIAN_REPS}; "
        f"{oracle_us / host_us:.0f}x) {where}")
    absorbed = [int(v) for v in msgs[:, 0]]
    sched_us = median_us(lambda: host.host_run_schedule(bls, fiat_shamir.STEPS, absorbed))
    plan = compile_transcript(bls, fiat_shamir.SCHEDULE)
    ms1, _ = time_ms(lambda: plan(fs_elems[..., :1]), reps=20)
    ms_big, _ = time_ms(lambda: plan(fs_elems), reps=3)
    say("host", f"Fiat-Shamir transcript (4 permutations): host_run_schedule {sched_us:.2f} us per transcript "
        f"(median of {MEDIAN_REPS}); the card's compiled transcript {ms1:.3f} ms at B=1, {ms_big:.3f} ms at "
        f"B={FS_LANES} = {ms_big * 1e6 / FS_LANES:.1f} ns per transcript {where}")
    tmp = pathlib.Path(tempfile.mkdtemp(dir=pathlib.Path(__file__).resolve().parent / "build"))
    with profiling.trace(tmp):
        traced = plan(fs_elems)
    check(torch.equal(traced, challenges), "traced transcript != the example's challenges")
    busy = profiling.device_busy_share(tmp)
    shutil.rmtree(tmp)
    k1_us = sum(us for n, us in busy["kernels"].items() if "poseidon_opt_kernel" in n)
    check(k1_us > 0, "kernel 1 is not among the transcript trace's CUDA kernels")
    say("trace", f"compiled transcript at B={FS_LANES} under torch.profiler: window {busy['window_us'] / 1e3:.3f} ms, "
        f"kernel 1 {k1_us / 1e3:.3f} ms, other CUDA kernels {(busy['kernel_us'] - k1_us) / 1e3:.3f} ms "
        f"({len(busy['kernels']) - 1} kinds), device busy {busy['busy_share'] * 100:.1f}% [{gpu}]")
    big = states[tour[0][0]]
    ins = [limbs_to_ints(fs, row) for row in mont.from_mont(fs, big).int().cpu().numpy()]
    flat = [v for lane_ in zip(*ins) for v in lane_]
    threads = min(os.cpu_count() or 1, 16)
    t0 = time.perf_counter()
    host.host_permute_states(bls, flat)
    e2e_s = time.perf_counter() - t0
    words = np.ascontiguousarray(host._to_mont_words(fs.modulus, flat))
    t0 = time.perf_counter()
    host._call_permute(native.get_poseidon_lib(), bls, words, B_HOST, threads)
    native_s = time.perf_counter() - t0
    say("host", f"host_permute_states {fs.name} rate 2 at {B_HOST} states, {threads} threads: {B_HOST / e2e_s:,.0f} "
        f"perms/s with the Python word conversion, {B_HOST / native_s:,.0f} perms/s in the native call alone "
        f"{where}")
    vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B_MAIN)]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    t0 = time.perf_counter()
    enc = native.encode_mont_plane_native(fs, buf, B_MAIN)
    enc_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc_pure = ints_to_limbs(fs, [fs.to_mont(v) for v in vals])
    enc_pure_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = native.decode_mont_plane_native(fs, enc)
    dec_native = time.perf_counter() - t0
    r_inv, p = fs.r_inv, fs.modulus
    t0 = time.perf_counter()
    dec_pure = [v * r_inv % p for v in limbs_to_ints(fs, enc_pure)]
    dec_pure_s = time.perf_counter() - t0
    check(np.array_equal(enc, enc_pure) and dec_pure == vals
          and raw == buf, "native and pure codecs disagree on 2^20 values")
    say("codec", f"{B_MAIN} {fs.name} values: encode native {enc_native:.3f} s, pure {enc_pure_s:.3f} s; decode native "
        f"{dec_native:.3f} s, pure {dec_pure_s:.3f} s (the 32-byte buffer's build not counted; results equal) "
        f"{where}")
    return launches


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
