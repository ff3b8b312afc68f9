"""Kernel 3: the Poseidon2 permutation, and its plain PyTorch version.

Counterpart of ``sponge_tpu/ops/pallas_p2.py`` (``p2_permute_fn``): small-int
M_E, M_I = J + diag(mu - 1).  The CUDA kernel is ``csrc/poseidon2.cu`` with
two bodies, chosen per config by ``ops/bounds.py`` ``check_p2_bounds``: the
limb body (Montgomery products only in the S-box and the diagonal when it is
not small, values kept below R by top-carry rho-folds whose counts per
round come from the replay ``p2_plan``), and for fields below 2^31 the
one-word body (one 32-bit Montgomery word per element, its constants in the
buffer's word section).

``permute_p2_plain`` computes the same function with int64 tensor ops,
canonical after every layer: each linear layer's unreduced limb sums go
through ``montgomery.reduce_small``.

``overwrite_permute_p2`` is Plonky3's overwrite sponge in one launch of the
one-word body (``csrc/poseidon2.cu`` ``SpongeIO``): from a zero state, the
rows of one or two views (any strides) written a chunk at a time over the
state's first rows, each chunk followed by the permutation, the state kept
in registers between them, then the first rows stored.  ``permute_p2`` runs
through the same launch (one view of t rows; the limb body reads the plane
itself).  ``overwrite_permute_p2_plain`` is the sponge's plain version: the
overwrite, ``permute_p2_plain`` and the slice, chunk by chunk.

Both take the plain version only for a tensor on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch

from ..poseidon.config import layout_size
from ..poseidon2.config import LIMB_SECTIONS, Poseidon2Config, constant_layout, unpack_constants
from . import _build
from . import montgomery as mont
from .bounds import check_p2_bounds

# (t, L) each body is compiled for (csrc/poseidon2.cu sponge_poseidon2); the
# union is _build.INSTANTIATIONS["sponge_poseidon2"].
BODIES = {
    "limb": frozenset({(3, 11), (4, 11), (8, 11), (8, 3), (12, 3), (8, 2), (3, 2)}),
    "word": frozenset({(16, 2), (8, 2), (3, 2)}),
}


def _small_mat(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def permute_p2_plain(cfg: Poseidon2Config, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The Poseidon2 permutation with int64 tensor ops (canonical in and out)."""
    fs, t, p = cfg.field, cfg.t, cfg.field.modulus
    c = unpack_constants(cfg, consts)
    ext, internal, diag_mont = c["ext"].long(), c["int"].long(), c["diag_mont"].long()
    mat_e = _small_mat(cfg.mat_e, state.device)
    dm1 = cfg.diag_m1
    row_max = max(sum(row) for row in cfg.mat_e)
    half = cfg.full_rounds // 2

    def external(x):
        y = sum(mat_e[:, j, None, None] * x[j] for j in range(t))
        return mont.reduce_small(fs, y, row_max * (p - 1) + 1)

    def external_round(x, r):
        return external(mont.mont_pow(fs, mont.mont_add(fs, x, ext[r]), cfg.alpha))

    x = external(state.long())
    for r in range(half):
        x = external_round(x, r)
    for r in range(cfg.partial_rounds):
        x0 = mont.mont_pow(fs, mont.mont_add(fs, x[:1], internal[r]), cfg.alpha)
        x = torch.cat([x0, x[1:]])
        sigma = x.sum(0)
        if cfg.small_diag:
            y = sigma + _small_mat(dm1, state.device)[:, None, None] * x
            x = mont.reduce_small(fs, y, (t + max(dm1)) * (p - 1) + 1)
        else:
            x = mont.reduce_small(fs, sigma + mont.mont_mul(fs, x, diag_mont), (t + 1) * (p - 1) + 1)
    for r in range(half, cfg.full_rounds):
        x = external_round(x, r)
    return x.int()


@functools.lru_cache(maxsize=None)
def _fold_table(cfg: Poseidon2Config, device: torch.device) -> torch.Tensor:
    """The limb body's fold counts (``P2Plan.folds``) as a device int32
    table, built once per config and device."""
    return torch.tensor(check_p2_bounds(cfg).folds, dtype=torch.int32, device=device).reshape(-1)


def _launch_args(cfg: Poseidon2Config, consts: torch.Tensor):
    """The body and its plan (``check_p2_bounds``), then kernel 3's own C
    arguments: the body code, the rounds, alpha, the small-diagonal flag, the
    constants the body reads and their length, the fold table (limb body)
    and n0inv."""
    plan = check_p2_bounds(cfg)
    shape = (cfg.t, cfg.field.nlimbs)
    if shape not in BODIES[plan.body]:
        raise NotImplementedError(
            f"no CUDA kernel instantiation of kernel 3's {plan.body} body for t={cfg.t}, L={cfg.field.nlimbs}; "
            f"compiled: {sorted(BODIES[plan.body])}"
        )
    layout = constant_layout(cfg)
    limb_words = layout_size(layout[:LIMB_SECTIONS])
    if plan.body == "limb":
        body, ptr, words, table = 0, consts.data_ptr(), limb_words, _fold_table(cfg, consts.device).data_ptr()
    else:
        body, ptr, table = 2 if plan.structured else 1, consts[limb_words:].data_ptr(), None
        words = layout_size(layout) - limb_words
    return (
        body, cfg.full_rounds, cfg.partial_rounds, cfg.alpha, int(cfg.small_diag), ptr, words, table,
        cfg.field.n0inv,
    )


def overwrite_permute_p2_plain(cfg: Poseidon2Config, consts: torch.Tensor, views: tuple, width: int,
                               out_rows: int) -> torch.Tensor:
    """``overwrite_permute_p2`` with tensor ops: each chunk written over a
    new state's first rows, ``permute_p2_plain``, the rows kept."""
    rows = torch.cat(views)
    state = torch.zeros((cfg.t, cfg.field.nlimbs, rows.shape[-1]), dtype=torch.int32, device=rows.device)
    for lo in range(0, rows.shape[0], width):
        chunk = rows[lo : lo + width]
        state = permute_p2_plain(cfg, consts, torch.cat([chunk, state[chunk.shape[0] :]]))
    return state[:out_rows].clone()


def overwrite_permute_p2(cfg: Poseidon2Config, consts: torch.Tensor, views: tuple, width: int,
                         out_rows: int) -> torch.Tensor:
    """Plonky3's overwrite sponge on kernel 3's one-word body: from a zero
    state, the rows of the canonical (k, L, B) int32 ``views`` (one or two,
    of any strides; the second's rows follow the first's) taken ``width``
    at a time (the last chunk may be shorter), each chunk written over
    state rows [0, len(chunk)) and the state permuted; then rows
    [0, ``out_rows``) as a new (out_rows, L, B) plane.  No rows give the
    zero state's rows, with no permutation.  ``consts`` is
    ``kernel_constants(cfg)`` on the views' device.  Raises for a config of
    the limb body, views of different lanes, devices or dtypes, the wrong
    L, a width or ``out_rows`` outside [1, t]."""
    t, L = cfg.t, cfg.field.nlimbs
    if not 1 <= len(views) <= 2 or any(v.dim() != 3 for v in views):
        raise ValueError("views must be one or two (k, L, B) planes")
    if any(v.shape[1] != L for v in views):
        raise ValueError(f"views must have L = {L} limbs, got {[v.shape[1] for v in views]}")
    if any(v.dtype != torch.int32 for v in views):
        raise TypeError("views must be int32")
    B, device = views[0].shape[-1], views[0].device
    if any(v.shape[-1] != B for v in views):
        raise ValueError(f"views of different lanes: {[v.shape[-1] for v in views]}")
    if any(v.device != device for v in views):
        raise ValueError(f"views on different devices: {[str(v.device) for v in views]}")
    if not 1 <= width <= t or not 1 <= out_rows <= t:
        raise ValueError(f"width {width} and out_rows {out_rows} must lie in [1, t = {t}]")
    if check_p2_bounds(cfg).body != "word":
        raise ValueError(f"the overwrite sponge runs on kernel 3's one-word body; {cfg.field.name} takes the limb body")
    _build.check_constants(consts, device, constant_layout(cfg))
    if not sum(v.shape[0] for v in views):
        return torch.zeros((out_rows, L, B), dtype=torch.int32, device=device)
    if device.type == "cpu":
        return overwrite_permute_p2_plain(cfg, consts, views, width, out_rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return _launch(cfg, consts, views, width, out_rows)


def permute_p2(cfg: Poseidon2Config, consts: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a (t, L, B) int32 canonical Montgomery plane:
    the overwrite sponge's launch with one chunk of all t rows, every row
    kept.  ``consts`` is ``poseidon2.config.kernel_constants(cfg)`` on the
    state's device."""
    _build.check_state(cfg, consts, state, constant_layout(cfg))
    if state.device.type == "cpu":
        return permute_p2_plain(cfg, consts, state)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    return _launch(cfg, consts, (state,), cfg.t, cfg.t)


def _launch(cfg: Poseidon2Config, consts: torch.Tensor, views: tuple, width: int, out_rows: int) -> torch.Tensor:
    """One launch of kernel 3 over checked arguments: its (t, L)
    instantiation, its body's arguments (``_launch_args``), then the views'
    pointers, rows and element strides, the width and the rows kept.  The
    limb body runs the plain permutation alone, on one contiguous view of t
    rows.  Counted in ``permute_p2.launches``."""
    t, L, B = cfg.t, cfg.field.nlimbs, views[0].shape[-1]
    _build.check_instantiated("sponge_poseidon2", t, L)
    args = _launch_args(cfg, consts)
    out = torch.empty((out_rows, L, B), dtype=torch.int32, device=consts.device)
    if B:
        io = [(v.data_ptr(), v.shape[0], *v.stride()) for v in views] + [(None, 0, 0, 0, 0)] * (2 - len(views))
        (_, k0, *strides0), (ptr1, k1, *strides1) = io
        _build.launch("sponge_poseidon2", views[0], out, *args, ptr1, k0, k1, *strides0, *strides1, width, out_rows,
                      shape=(t, L, B))
        permute_p2.launches += 1
    return out


permute_p2.launches = 0
