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
from ctypes import POINTER, c_int, c_longlong, c_uint, c_void_p

import torch

from ..poseidon.config import layout_size

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sponge_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (t, L) pairs compiled into each kernel: rate 2 over the 255/254-bit fields
# (3, 11); the 31-bit fields at capacity 8, rate 8 (16, 2); the 35-bit and
# 25-bit test fields (3, 2); the 44-bit low-headroom test field at t = 8;
# Goldilocks at capacity 4, rate 4 (8, 3); Anemoi at rates 3 and 1 over the
# 255/254-bit fields (4, 11), (2, 11) and rate 3 over the 25-bit field (4, 2);
# Monolith at Goldilocks rates 8 and 4 (12, 3), (8, 3), at the 31-bit fields
# rate 8 (16, 2) and the dense capacity-2 test configs (4, 2).  The chain
# probe's (t, L) are (chains per thread, 32-bit words per chain value); the
# ablation probe runs kernel 1's BLS12-381 schedule.
INSTANTIATIONS = {
    "sponge_poseidon_opt": frozenset({(3, 11), (3, 2)}),
    "sponge_poseidon_dense": frozenset({(3, 11), (3, 2)}),
    "sponge_poseidon2": frozenset({(3, 11), (16, 2), (8, 2), (3, 2)}),
    "sponge_rescue": frozenset({(3, 11), (16, 2), (3, 2)}),
    "sponge_gmimc": frozenset({(3, 11), (8, 3), (3, 2)}),
    "sponge_griffin": frozenset({(3, 11), (8, 3), (3, 2)}),
    "sponge_anemoi": frozenset({(4, 11), (2, 11), (8, 3), (4, 2)}),
    "sponge_monolith": frozenset({(12, 3), (8, 3), (16, 2), (4, 2)}),
    "sponge_probe_chains": frozenset(
        {(c, w) for c in (1, 4, 8, 16) for w in (1, 2)} | {(1, 11), (2, 11)}
    ),
    "sponge_probe_ablation": frozenset({(3, 11)}),
}

# Arguments between (in, out, B, t, L) and the stream, per symbol (the C
# functions in csrc/*.cu).
SIGNATURES = {
    # alpha, full rounds, partial rounds, constants, n0inv
    "sponge_poseidon_opt": [c_int, c_int, c_int, c_void_p, c_uint],
    "sponge_poseidon_dense": [c_int, c_int, c_int, c_void_p, c_uint],
    # full rounds, partial rounds, alpha ladder length, small diagonal,
    # fold counts (host int[5]), constants, n0inv
    "sponge_poseidon2": [c_int, c_int, c_int, c_int, POINTER(c_int), c_void_p, c_uint],
    # rounds, alpha and inverse-alpha ladder lengths, constants, n0inv
    "sponge_rescue": [c_int, c_int, c_int, c_void_p, c_uint],
    # rounds, alpha, constants, n0inv
    "sponge_gmimc": [c_int, c_uint, c_void_p, c_uint],
    # rounds, alpha, inverse-alpha ladder length, post-linear reduction,
    # constants, n0inv
    "sponge_griffin": [c_int, c_uint, c_int, c_int, c_void_p, c_uint],
    # rounds, inverse-alpha ladder length, post-PHT reduction, constants, n0inv
    "sponge_anemoi": [c_int, c_int, c_int, c_void_p, c_uint],
    # rounds, bars, Bar chunk count, Mersenne body, scaled Concrete, plan
    # (host int[6]: fold counts, bit length, Mersenne shift), constants, n0inv
    "sponge_monolith": [c_int, c_int, c_int, c_int, c_int, POINTER(c_int), c_void_p, c_uint],
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
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists:
    each ``.cu`` to an object (in parallel), then one shared library.  Raises
    with nvcc's output on failure.  The ptxas report (registers and spills per
    kernel) is kept beside the library as ``<name>.ptxas.txt``."""
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
            logs = list(pool.map(_run, cmds))
        logs.append(_run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text(
        f"# {' '.join(NVCC_FLAGS)}\n# {time.perf_counter() - t0:.1f} s\n" + "".join(logs)
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


def launch(symbol: str, state, out, *args) -> None:
    """Launch ``symbol`` on the current CUDA stream of ``state``'s device with
    the symbol's own arguments ``args`` (``SIGNATURES``); raises if the launch
    is refused."""
    t, L, B = state.shape
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = getattr(library(), symbol)(state.data_ptr(), out.data_ptr(), B, t, L, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def check_state(cfg, consts: torch.Tensor, state: torch.Tensor, layout) -> None:
    """Validate a (t, L, B) int32 state plane and its constant buffer, laid
    out by ``layout`` (the config family's ``constant_layout(cfg)``)."""
    size = layout_size(layout)
    shape = (cfg.t, cfg.field.nlimbs)
    if state.dim() != 3 or tuple(state.shape[:2]) != shape:
        raise ValueError(f"state must be (t, L, B) = {shape + ('B',)}, got {tuple(state.shape)}")
    if state.dtype != torch.int32 or consts.dtype != torch.int32:
        raise TypeError("state and constants must be int32")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if tuple(consts.shape) != (size,) or not consts.is_contiguous():
        raise ValueError(f"constants must be kernel_constants(cfg): {size} words")
    if consts.device != state.device:
        raise ValueError(f"constants on {consts.device}, state on {state.device}")


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
