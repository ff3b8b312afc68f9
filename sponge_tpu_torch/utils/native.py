"""ctypes loader for the native host runtime and codec (``csrc/host/``).

Counterpart of ``sponge_tpu/utils/native.py``.  Two C++ sources ship with the
port: ``poseidon_host.cc`` (scalar 4 x 64-bit Montgomery permutations and
whole-schedule duplex drivers of every family, R = 2^256) and
``host_codec.cc`` (canonical values <-> the port's 11 x 24-bit Montgomery
limb planes, R = 2^264, and the byte packer).

Each library is built on first use with the system C++ compiler into
``build/sponge_tpu_torch/host/`` under the repository root, named by a hash
of its source.  Concurrent first uses (several test processes, say) are
serialised by an advisory lock on the build directory, and each compiler
writes a per-process temporary that ``os.replace`` puts in place, so no
process ever loads a torn library.  ``get_lib`` and ``get_poseidon_lib``
return None when no compiler exists or the build fails: every caller then
takes the pure-Python path.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sponge_tpu_torch" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
NLIMBS = 11  # the codec's plane: 11 x 24-bit limbs (the 253-255-bit fields)

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _compiler() -> Optional[str]:
    for cc in ("c++", "g++", "clang++"):
        path = shutil.which(cc)
        if path:
            return path
    return None


def library_path(src: pathlib.Path, stem: str) -> pathlib.Path:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def _compile_shared(src: pathlib.Path, stem: str) -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and dlopen a ``csrc/host`` file, or None."""
    cc = _compiler()
    if cc is None or not src.exists():
        return None
    so = library_path(src, stem)
    if not so.exists():
        try:
            so.parent.mkdir(parents=True, exist_ok=True)
            with open(so.parent / f".{stem}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                if not so.exists():
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    try:
                        subprocess.run(
                            [cc, *CXX_FLAGS, "-o", str(tmp), str(src)],
                            check=True, capture_output=True, timeout=600,
                        )
                        os.replace(tmp, so)
                    finally:
                        tmp.unlink(missing_ok=True)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native codec (``host_codec.cc``), or None (pure-Python path)."""
    lib = _compile_shared(CSRC / "host_codec.cc", "hostcodec")
    if lib is None:
        return None
    lib.encode_mont_plane.argtypes = [_vp, _i64, _vp, _vp]
    lib.encode_mont_plane.restype = None
    lib.decode_mont_plane.argtypes = [_vp, _i64, _vp, _vp]
    lib.decode_mont_plane.restype = None
    lib.pack_bytes_to_elements.argtypes = [_vp, _i64, _i64, _vp]
    lib.pack_bytes_to_elements.restype = _i64
    return lib


# Argument tables of poseidon_host.cc's entry points, in order.  fctx is
# p (4 x u64 LE) + n0inv; every table is Montgomery form (R = 2^256) as
# 4 x u64 LE words unless noted; states (n*t*4 u64) are permuted in place;
# a sponge run takes steps (n_steps x {kind, count} int32), the absorbed
# elements, the squeeze output, state_io (t*4 u64, in/out) and bk ({mode,
# index} int32, in/out).
_SPONGE_TAIL = [
    _vp,   # steps
    _i64,  # n_steps
    _vp,   # elems
    _vp,   # out
    _vp,   # state_io
    _vp,   # bk
]
_BATCH_TAIL = [_vp, _i64, _i32]  # states, n, n_threads
POSEIDON_SIGNATURES = {
    # fctx, t, alpha, full_rounds, partial_rounds, ark, mds, opt (nullable
    # packed optimized-partial tables)
    "poseidon_permute_host": [_vp, _i32, _i32, _i32, _i32, _vp, _vp, _vp, *_BATCH_TAIL],
    # ... rate, capacity, ark, mds, opt
    "poseidon_sponge_run": [_vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, *_SPONGE_TAIL],
    # fctx, t, alpha, full_rounds, partial_rounds, ext_rc (R_F*t), int_rc
    # (R_P), mat_e (t*t int32 plain), diag_m1 (t, mu-1), diag_small (t int32
    # plain mu-1, nullable fast path)
    "poseidon2_permute_host": [_vp, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, *_BATCH_TAIL],
    "poseidon2_sponge_run": [
        _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, *_SPONGE_TAIL
    ],
    # fctx, t, alpha, rounds, rc (2*rounds*t), mds (t*t), inv_alpha (4 u64
    # LE plain exponent), one_mont
    "rescue_permute_host": [_vp, _i32, _i32, _i32, _vp, _vp, _vp, _vp, *_BATCH_TAIL],
    "rescue_sponge_run": [_vp, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp, *_SPONGE_TAIL],
    # fctx, t, alpha, rounds, rc_x, rc_y (rounds*l), mat (l*l), g, g_inv,
    # inv_alpha, one_mont
    "anemoi_permute_host": [
        _vp, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, *_BATCH_TAIL
    ],
    "anemoi_sponge_run": [
        _vp, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, *_SPONGE_TAIL
    ],
    # fctx, t, alpha, rounds, rc ((rounds-1)*t), mat_e (t*t int32 plain),
    # qa, qb ((t-2) each), inv_alpha, one_mont
    "griffin_permute_host": [_vp, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, *_BATCH_TAIL],
    "griffin_sponge_run": [
        _vp, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, *_SPONGE_TAIL
    ],
    # fctx, t, alpha, rounds, rc (rounds)
    "gmimc_permute_host": [_vp, _i32, _i32, _i32, _vp, *_BATCH_TAIL],
    "gmimc_sponge_run": [_vp, _i32, _i32, _i32, _i32, _i32, _vp, *_SPONGE_TAIL],
    # fctx, t, rounds, bars, n_bits, bar_m (extra chunk boundary; 0/1 =
    # none), rc (rounds*t, last row zero), concrete (t*t), r2 (R^2 mod p)
    "monolith_permute_host": [_vp, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, *_BATCH_TAIL],
    "monolith_sponge_run": [
        _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, *_SPONGE_TAIL
    ],
}


@functools.lru_cache(maxsize=None)
def get_poseidon_lib() -> Optional[ctypes.CDLL]:
    """The native host runtime (``poseidon_host.cc``), or None."""
    lib = _compile_shared(CSRC / "poseidon_host.cc", "poseidonhost")
    if lib is None:
        return None
    for name, args in POSEIDON_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def _field_ctx(fs) -> np.ndarray:
    """p ‖ c_enc ‖ c_dec ‖ n0inv as 32-bit words.

    The native word-CIOS radix is R_c = 2^256; the plane's limb radix is
    R_dev = 2^(24 * 11) = 2^264.  c_enc = R_c*R_dev mod p maps canonical ->
    plane Montgomery form in one native multiply; c_dec = R_c/R_dev mod p
    maps back.
    """
    p = fs.modulus
    r_c = 1 << 256
    r_dev = fs.r
    ctx = np.zeros(25, dtype=np.uint32)
    ctx[0:8] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint32)
    ctx[8:16] = np.frombuffer((r_c * r_dev % p).to_bytes(32, "little"), dtype=np.uint32)
    ctx[16:24] = np.frombuffer(
        (r_c * pow(r_dev, -1, p) % p).to_bytes(32, "little"), dtype=np.uint32
    )
    ctx[24] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return ctx


def codec_field(fs) -> bool:
    """True for a field the codec serves exactly: 11 limbs, p < 2^256 (the
    words) and p > 2^252, so that a canonical-limb value (< 2^264) is below
    p * 2^12, the reach of the decoder's shift-and-subtract reduction."""
    return fs.nlimbs == NLIMBS and 253 <= fs.modulus_bit_size <= 256


def encode_mont_plane_native(fs, values_le: bytes, n: int) -> Optional[np.ndarray]:
    """n canonical 32-byte-LE values -> (L, n) int32 Montgomery plane, or None
    (no library, or a field the codec does not serve)."""
    lib = get_lib()
    if lib is None or not codec_field(fs):
        return None
    if len(values_le) != 32 * n:
        raise ValueError(f"expected {32 * n} bytes for {n} values, got {len(values_le)}")
    out = np.empty((NLIMBS, n), dtype=np.int32)
    buf = np.frombuffer(values_le, dtype=np.uint8)
    ctx = _field_ctx(fs)
    lib.encode_mont_plane(buf.ctypes.data, n, ctx.ctypes.data, out.ctypes.data)
    return out


def decode_mont_plane_native(fs, plane: np.ndarray) -> Optional[bytes]:
    """(L, n) int32 Montgomery plane -> n canonical 32-byte-LE values, or None.

    Limbs may be redundant (above 2^24) as long as they are non-negative and
    the plane's limb maxima, summed at their weights, stay below p * 2^12,
    the reach of the decoder's shift-and-subtract reduction; canonical limbs
    always do.  Any other plane raises ValueError."""
    lib = get_lib()
    if lib is None or not codec_field(fs):
        return None
    plane = np.ascontiguousarray(plane, dtype=np.int32)
    if plane.ndim != 2 or plane.shape[0] != NLIMBS:
        raise ValueError(f"expected an ({NLIMBS}, n) plane, got shape {plane.shape}")
    if plane.size and plane.min() < 0:
        raise ValueError("limb plane has negative limbs")
    if plane.size and sum(int(m) << (24 * l) for l, m in enumerate(plane.max(axis=1))) >= fs.modulus << 12:
        raise ValueError("limb plane may hold values at or above p * 2^12, past the decoder's reach")
    n = plane.shape[1]
    out = np.empty(n * 32, dtype=np.uint8)
    ctx = _field_ctx(fs)
    lib.decode_mont_plane(plane.ctypes.data, n, ctx.ctypes.data, out.ctypes.data)
    return out.tobytes()


def pack_bytes_to_elements_native(fs, data: bytes):
    """Byte stream -> list of ints via the native chunk packer, or None for
    the pure-Python path."""
    lib = get_lib()
    chunk = (fs.modulus_bit_size - 1) // 8
    if lib is None or chunk > 32 or not data:
        return None  # the Python path handles these (empty -> [])
    n = (len(data) + chunk - 1) // chunk
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(n * 32, dtype=np.uint8)
    lib.pack_bytes_to_elements(buf.ctypes.data, len(data), chunk, out.ctypes.data)
    raw = out.tobytes()
    return [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(n)]
