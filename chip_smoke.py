"""On-card smoke test of the PyTorch/CUDA port (sponge_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds both CUDA kernels from sponge_tpu_torch/csrc with nvcc, holds each
against its plain PyTorch version and the scalar oracle, drives the main
path at full size (the batched BLS12-381 Fr rate-2 permutation at B = 2^20,
the lazy sponge, a 2^20-leaf Merkle root), and times the kernels beside the
plain versions with CUDA events.  Each phase prints one line; any failure
raises and exits non-zero.  The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device it exits non-zero and prints no result.  It imports nothing of
JAX or sponge_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260516
B_MAIN = 1 << 20
B_CHECK = 1 << 16


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
    """Put 0, 1, p-1, p-2 in every element position: lanes 0..63 run all 4^3
    combinations over the three elements."""
    edges = [fs.ints_to_mont_plane([v])[:, 0] for v in (0, 1, fs.modulus - 1, fs.modulus - 2)]
    plane = plane.clone()
    for b in range(64):
        for e in range(plane.shape[0]):
            plane[e, :, b] = torch.from_numpy(edges[(b >> (2 * e)) & 3])
    return plane


def lane_ints(fs, plane, b):
    return [fs.mont_plane_to_ints(plane[e, :, b : b + 1].cpu().numpy())[0] for e in range(plane.shape[0])]


def oracle_permute(st, cfg, vals):
    o = st.OraclePoseidonSponge(cfg)
    o.state = list(vals)
    o.permute()
    return o.state


def check_lanes_vs_oracle(st, cfg, state_in, state_out, lanes, what):
    for b in lanes:
        want = oracle_permute(st, cfg, lane_ints(cfg.field, state_in, b))
        check(lane_ints(cfg.field, state_out, b) == want, f"{what}: lane {b} differs from the oracle")


def time_ms(fn, reps=3):
    """CUDA-event time of fn(): one warm call, then the best of ``reps``."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2

    import sponge_tpu_torch as st
    from sponge_tpu_torch.fields import mont_tensor_to_ints
    from sponge_tpu_torch.hash import compress_pairs, merkle_root
    from sponge_tpu_torch.ops import _build
    from sponge_tpu_torch.ops.bounds import check_kernel_bounds
    from sponge_tpu_torch.ops.poseidon_dense import permute_dense, permute_dense_plain
    from sponge_tpu_torch.ops.poseidon_opt import permute_opt, permute_opt_plain
    from sponge_tpu_torch.poseidon.permutation import permutation_for

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # ---- 1. environment and build ----
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    say("env", "nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    say("env", f"card: {gpu}")
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

    # ---- 2. golden vector and the reference test fixture ----
    s = st.PoseidonSponge(bls, batch_size=4, device=dev)
    s.absorb([st.Fp(v, st.BLS12_381_FR) for v in (0, 1, 2)])
    got = s.squeeze_native_field_elements(3)
    golden = 40442793463571304028337753002242186710310163897048962278675457993207843616876
    check(all(lane[0] == golden for lane in got), f"golden vector: got {got[0][0]}")
    say("golden", f"sponge squeeze[0] == {golden} on all 4 lanes")
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
            wrapper=permute_opt, plain=permute_opt_plain, optimized=True,
            source="sponge_tpu_torch/csrc/poseidon_opt.cu",
            replaces="sponge_tpu/ops/pallas_cios.py:1248", max_abs_err=0,
        ),
        "poseidon_permute_dense": dict(
            wrapper=permute_dense, plain=permute_dense_plain, optimized=False,
            source="sponge_tpu_torch/csrc/poseidon_dense.cu",
            replaces="sponge_tpu/ops/pallas_permute.py:96", max_abs_err=0,
        ),
    }
    sample = list(range(0, 64, 2)) + sorted(rng.choice(np.arange(64, B_CHECK), 32, replace=False).tolist())
    for cfg in (bls, bn, tiny):
        perm = permutation_for(cfg, dev)
        state = with_edges(cfg.field, random_plane(cfg.field, (cfg.t, cfg.field.nlimbs, B_CHECK), rng, dev))
        for name, k in kernels.items():
            vmax = check_kernel_bounds(cfg, k["optimized"])
            out_k = k["wrapper"](cfg, perm.consts, state)
            torch.cuda.synchronize()
            out_p = k["plain"](cfg, perm.consts, state)
            err = int((out_k.long() - out_p.long()).abs().max())
            k["max_abs_err"] = max(k["max_abs_err"], err)
            check(torch.equal(out_k, out_p), f"{name} != plain on {cfg.field.name} (max err {err})")
            check_lanes_vs_oracle(st, cfg, state, out_k, sample, f"{name} {cfg.field.name}")
            say(
                "kernel",
                f"{name} {cfg.field.name} t={cfg.t} L={cfg.field.nlimbs}: torch.equal(kernel, plain) "
                f"at B={B_CHECK} incl. 64 edge lanes; 64 lanes == oracle; value bound "
                f"{vmax / cfg.field.modulus:.1f}p of R = {cfg.field.r / cfg.field.modulus:.1f}p",
            )

    # ---- 4+5. the main path, launches counted ----
    fs = bls.field
    perm = permutation_for(bls, dev)
    state = with_edges(fs, random_plane(fs, (bls.t, fs.nlimbs, B_MAIN), rng, dev))
    leaves = random_plane(fs, (fs.nlimbs, B_MAIN), rng, dev)
    lane_vals = random_plane(fs, (2, fs.nlimbs, B_CHECK), rng, dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    out = st.batched_permute(bls, state)  # kernel 2
    parity = st.batched_permute(bls, state, backend="dense")  # kernel 1: the second parity tier
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
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    say("launches", json.dumps(launches))

    check(out.shape == state.shape and torch.equal(out, parity), "kernel 2 != kernel 1 at B = 2^20")
    main_sample = list(range(0, 64, 2)) + sorted(rng.choice(np.arange(64, B_MAIN), 32, replace=False).tolist())
    check_lanes_vs_oracle(st, bls, state, out, main_sample, "batched_permute B=2^20")
    say("main", f"batched_permute {fs.name} rate 2 at B=2^20: kernel 2 == kernel 1; 64 lanes == oracle")

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

    plain_root = merkle_root(bls, leaves, backend="plain")
    check(torch.equal(root, plain_root), "Merkle root over 2^20 leaves: kernel != plain")
    small = leaves[:, :1024]
    level = mont_tensor_to_ints(fs, small)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = st.OraclePoseidonSponge(bls)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    check(mont_tensor_to_ints(fs, merkle_root(bls, small)[:, None]) == level, "2^10 Merkle root != oracle")
    say("merkle", "root over 2^20 leaves: kernel == plain; root over 2^10 leaves == oracle")

    # ---- timing at the main path's shape ----
    for name, k in kernels.items():
        k["ms"] = time_ms(lambda: k["wrapper"](bls, perm.consts, state))
        k["plain_ms"] = time_ms(lambda: k["plain"](bls, perm.consts, state))
        say(
            "time",
            f"{name} B=2^20: kernel {k['ms']:.3f} ms = {B_MAIN / k['ms'] * 1e3:,.0f} perms/s; "
            f"plain torch {k['plain_ms']:.1f} ms = {B_MAIN / k['plain_ms'] * 1e3:,.0f} perms/s [{gpu}]",
        )

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


if __name__ == "__main__":
    sys.exit(main())
