"""Build and bind the port's CUDA kernels.

``library()`` compiles every ``sponge_tpu_torch/csrc/*.cu`` with nvcc into
one shared library with a plain C interface, the first time a kernel is
launched, and loads it with ctypes.  The library lives in
``build/sponge_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Importing this module builds nothing: CPU-only machines never need
nvcc.

Each kernel symbol has its own C signature (``SIGNATURES``) and its own
instantiated (t, L) pairs (``INSTANTIATIONS``); ``check_instantiated`` raises
for any other shape.  Every signature starts ``(in, out, B, t, L, ...)`` and
ends with the CUDA stream; ``launch`` fills both ends.  ``run`` is the body
every kernel wrapper in ``ops/`` shares.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from ctypes import POINTER, c_int, c_longlong, c_uint, c_ulonglong, c_void_p

import torch

from ..poseidon.config import layout_size

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sponge_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (t, L) pairs compiled into each kernel.  Every kernel covers every width
# of its family's default tables over the seven fields at rates 1-8.
# Kernels 1 and 2 (POSEIDON_PAIRS; kernel 2's bodies: ops/poseidon_dense.py
# BODIES) and kernel 3 (ops/poseidon2.py BODIES)
# (poseidon/params.py, poseidon2/params.py): the 255/254-bit fields at rates
# 2-8 (t = 3..9, L = 11; Poseidon2 rates 2, 3 and 7), Goldilocks at rates 4
# and 8 (8, 3), (12, 3), the 31-bit fields at capacity 8, rate 8 (16, 2).
# Kernel 5 (Rescue-Prime, capacity 1 at L = 11, 4 at Goldilocks, 8 at the
# 31-bit fields): t = 2..9 at L = 11, 5..12 at L = 3, 9..16 at L = 2.
# Kernel 8 (GMiMC-erf; ops/gmimc.py BODIES): its limb body t = 2..9 at
# L = 11, its two-word body Goldilocks t = 5..12.  Kernel 6 (Griffin-pi,
# t = 3, 4, 8 and Goldilocks 8, 12) and kernel 7 (Anemoi, t = 2, 4, 6, 8 at
# L = 11 and Goldilocks 6..12 even).  Monolith at Goldilocks rates 8 and 4
# (12, 3), (8, 3), at the 31-bit fields rate 8 (16, 2).  Besides them the
# 35-bit and 25-bit test fields (3, 2), the 44-bit low-headroom test field
# at t = 8, the 25-bit Anemoi (4, 2) and the dense capacity-2 Monolith test
# configs (4, 2).  The chain probe's (t, L) are (chains per thread, 32-bit
# words per chain value); the ablation probe runs kernel 1's BLS12-381
# schedule.
POSEIDON_PAIRS = frozenset({(t, 11) for t in range(3, 10)} | {(8, 3), (12, 3), (16, 2), (3, 2)})
INSTANTIATIONS = {
    "sponge_poseidon_opt": POSEIDON_PAIRS,
    "sponge_poseidon_dense": POSEIDON_PAIRS,
    "sponge_poseidon2": frozenset({(3, 11), (4, 11), (8, 11), (8, 3), (12, 3), (16, 2), (8, 2), (3, 2)}),
    "sponge_rescue": frozenset(
        {(t, 11) for t in range(2, 10)} | {(t, 3) for t in range(5, 13)} | {(t, 2) for t in range(9, 17)} | {(3, 2)}
    ),
    "sponge_gmimc": frozenset({(t, 11) for t in range(2, 10)} | {(t, 3) for t in range(5, 13)} | {(3, 2)}),
    "sponge_griffin": frozenset({(3, 11), (4, 11), (8, 11), (8, 3), (12, 3), (3, 2)}),
    "sponge_anemoi": frozenset({(2, 11), (4, 11), (6, 11), (8, 11), (6, 3), (8, 3), (10, 3), (12, 3), (4, 2)}),
    "sponge_monolith": frozenset({(12, 3), (8, 3), (16, 2), (4, 2)}),
    "sponge_probe_chains": frozenset(
        {(c, w) for c in (1, 4, 8, 16) for w in (1, 2)} | {(1, 11), (2, 11)}
    ),
    "sponge_probe_ablation": frozenset({(3, 11)}),
}

# ptxas registers per thread of the kernels that size a window table
# (nvcc 12.9, NVCC_FLAGS): ops/montgomery.py window_for keeps the blocks per
# SM they allow.  chip_smoke.py checks that the build's own report gives
# every config the same window.
REGISTERS = {
    **{("sponge_rescue", t, 11): r for t, r in zip(range(2, 10), (128, 128, 164, 220, 240, 242, 255, 255))},
    **{("sponge_rescue", t, 3): r for t, r in zip(range(5, 13), (120, 126, 128, 128, 128, 128, 128, 128))},
    **{("sponge_rescue", t, 2): 128 for t in range(9, 17)},
    ("sponge_rescue", 3, 2): 56,
    ("sponge_anemoi", 2, 11): 74,
    ("sponge_anemoi", 4, 11): 128,
    ("sponge_anemoi", 6, 11): 140,
    ("sponge_anemoi", 8, 11): 172,
    ("sponge_anemoi", 6, 3): 46,
    ("sponge_anemoi", 8, 3): 56,
    ("sponge_anemoi", 10, 3): 64,
    ("sponge_anemoi", 12, 3): 72,
    ("sponge_anemoi", 4, 2): 32,
    ("sponge_griffin", 3, 11): 94,
    ("sponge_griffin", 4, 11): 130,
    ("sponge_griffin", 8, 11): 255,
    ("sponge_griffin", 8, 3): 64,
    ("sponge_griffin", 12, 3): 84,
    ("sponge_griffin", 3, 2): 32,
}


def registers(symbol: str, t: int, L: int) -> int:
    """``REGISTERS`` of an instantiation; 255 (a thread's most) for any
    other shape, which no kernel launches."""
    return REGISTERS.get((symbol, t, L), 255)


# Arguments between (in, out, B, t, L) and the stream, per symbol (the C
# functions in csrc/*.cu).
SIGNATURES = {
    # alpha, full rounds, partial rounds, constants, n0inv, then the rate
    # I/O (csrc/poseidon_opt.cu RateIO): two row views, the rows per view,
    # each view's element strides (row, limb, lane), the state row of the
    # first view, fresh, the stored rows [lo, hi)
    "sponge_poseidon_opt": [c_int, c_int, c_int, c_void_p, c_uint, c_void_p, c_void_p, c_int,
                            *[c_longlong] * 6, c_int, c_int, c_int, c_int],
    # the same, then the body (ops/poseidon_dense.py), the word bodies'
    # constants and their length
    "sponge_poseidon_dense": [c_int, c_int, c_int, c_void_p, c_uint, c_int, c_void_p, c_int],
    # body (ops/poseidon2.py), full rounds, partial rounds, alpha, small
    # diagonal, the body's constants and their length, fold table (device
    # int32, limb body), n0inv
    "sponge_poseidon2": [c_int, c_int, c_int, c_uint, c_int, c_void_p, c_int, c_void_p, c_uint],
    # rounds, alpha window and schedule length, inverse-alpha window and
    # schedule length, constants, n0inv
    "sponge_rescue": [c_int, c_int, c_int, c_int, c_int, c_void_p, c_uint],
    # body (ops/gmimc.py), rounds, alpha, front reduction (limb body), the
    # body's constants and their length, n0inv
    "sponge_gmimc": [c_int, c_int, c_uint, c_int, c_void_p, c_int, c_uint],
    # rounds, alpha, inverse-alpha window and schedule length, post-linear
    # reduction, constants and their length, n0inv
    "sponge_griffin": [c_int, c_uint, c_int, c_int, c_int, c_void_p, c_int, c_uint],
    # rounds, inverse-alpha window and schedule length, post-PHT reduction,
    # constants, n0inv
    "sponge_anemoi": [c_int, c_int, c_int, c_int, c_void_p, c_uint],
    # rounds, bars, Bar chunk pattern (ops/monolith.py chunk_pattern),
    # Mersenne body, circulant Concrete, plan (host int[6]: fold counts, bit
    # length, Mersenne shift), constants, n0inv
    "sponge_monolith": [c_int, c_int, c_ulonglong, c_int, c_int, POINTER(c_int), c_void_p, c_uint],
    # op, loop iterations, constants, clocks (device int64[2] or null), n0inv
    "sponge_probe_chains": [c_int, c_int, c_void_p, c_void_p, c_uint],
    # mode, alpha, full rounds, partial rounds, constants, n0inv
    "sponge_probe_ablation": [c_int, c_int, c_int, c_int, c_void_p, c_uint],
}
_HEAD = [c_void_p, c_void_p, c_longlong, c_int, c_int]  # in, out, B, t, L


def check_instantiated(symbol: str, t: int, L: int) -> None:
    if (t, L) not in INSTANTIATIONS[symbol]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of {symbol} for t={t}, L={L}; "
            f"compiled: {sorted(INSTANTIATIONS[symbol])}"
        )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libsponge_kernels_{_digest()}.so"


def _run(cmd):
    """Run one nvcc command; its output headed by the seconds it took."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    what = pathlib.Path(cmd[-1]).name if cmd[-1].endswith(".cu") else "link"
    return f"# {what}: {time.perf_counter() - t0:.1f} s\n" + proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists:
    each ``.cu`` to an object (in parallel), then one shared library.  Raises
    with nvcc's output on failure.  The ptxas report (registers and spills per
    kernel, each command's seconds) is kept beside the library as
    ``<name>.ptxas.txt``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    stem = out.with_suffix("")
    objs = [pathlib.Path(f"{stem}.{cu.stem}.{os.getpid()}.o") for cu in cus]
    cmds = [
        [_nvcc(), *NVCC_FLAGS, "-c", f"-I{CSRC}", "-o", str(obj), str(cu)]
        for cu, obj in zip(cus, objs)
    ]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            futures = [pool.submit(_run, cmd) for cmd in cmds]
        failed = [str(f.exception()) for f in futures if f.exception() is not None]
        if failed:  # every failing file, not only the first
            raise RuntimeError("\n\n".join(failed))
        logs = [f.result() for f in futures]
        logs.append(_run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text(
        f"# {' '.join(NVCC_FLAGS)}\n# all: {time.perf_counter() - t0:.1f} s\n" + "".join(logs)
    )
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """The ptxas report of the current library (build() first)."""
    return library_path().with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = _HEAD + args + [c_void_p]  # ... stream
        fn.restype = c_int
    return lib


def launch(symbol: str, state, out, *args, shape=None) -> None:
    """Launch ``symbol`` on the current CUDA stream of ``out``'s device with
    the symbol's own arguments ``args`` (``SIGNATURES``); raises if the launch
    is refused.  ``state`` None passes a null input (a kernel told to read
    none), and ``shape`` then gives its (t, L, B)."""
    t, L, B = state.shape if shape is None else shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(library(), symbol)(None if state is None else state.data_ptr(), out.data_ptr(), B, t, L,
                                        *args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def check_constants(consts: torch.Tensor, device, layout) -> None:
    """Validate a constant buffer laid out by ``layout`` (the config
    family's ``constant_layout(cfg)``) for data on ``device``."""
    size = layout_size(layout)
    if consts.dtype != torch.int32:
        raise TypeError("constants must be int32")
    if tuple(consts.shape) != (size,) or not consts.is_contiguous():
        raise ValueError(f"constants must be kernel_constants(cfg): {size} words")
    if consts.device != device:
        raise ValueError(f"constants on {consts.device}, data on {device}")


def check_state(cfg, consts: torch.Tensor, state: torch.Tensor, layout) -> None:
    """Validate a (t, L, B) int32 state plane and its constant buffer, laid
    out by ``layout`` (the config family's ``constant_layout(cfg)``)."""
    shape = (cfg.t, cfg.field.nlimbs)
    if state.dim() != 3 or tuple(state.shape[:2]) != shape:
        raise ValueError(f"state must be (t, L, B) = {shape + ('B',)}, got {tuple(state.shape)}")
    if state.dtype != torch.int32:
        raise TypeError("state must be int32")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    check_constants(consts, state.device, layout)


def run(wrapper, symbol: str, cfg, consts: torch.Tensor, state: torch.Tensor, layout, plain, launch_args):
    """The body of every kernel wrapper: check the plane and its constants;
    on a CPU tensor return ``plain(cfg, consts, state)``; on a CUDA tensor
    check the (t, L) instantiation, take ``launch_args(cfg, consts)`` (the
    family's bound check, then the symbol's own arguments), launch
    ``symbol`` and add one to ``wrapper.launches``.  Any other device
    raises."""
    check_state(cfg, consts, state, layout)
    if state.device.type == "cpu":
        return plain(cfg, consts, state)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    check_instantiated(symbol, cfg.t, cfg.field.nlimbs)
    args = launch_args(cfg, consts)
    out = torch.empty_like(state)
    if state.shape[-1]:
        launch(symbol, state, out, *args)
        wrapper.launches += 1
    return out
