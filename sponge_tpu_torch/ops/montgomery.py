"""Plain PyTorch Montgomery arithmetic over int64 limb planes.

Counterpart of ``sponge_tpu/ops/montgomery.py:140-270``.  Operands are
``(..., L, B)`` planes of 24-bit limbs (any integer dtype; computed in int64),
in Montgomery form with R = 2^(24 L).  Every function returns a canonical
int64 plane: value below p, limbs below 2^24.

A product is formed as 2L schoolbook columns and reduced by operand-scanning
REDC over those columns.  Limb products are below 2^48, so a column of a
t-term dot product plus its REDC terms stays below (t + 1) * L * 2^48, far
inside int64 for every shipped field (``ops/bounds.py`` checks it).  This is
the same arithmetic the CUDA kernels run in 64-bit registers, written with
tensor ops over the whole plane, so it runs on the CPU and on the card alike.
"""

from __future__ import annotations

import functools

import torch

from ..fields import LIMB_BITS, LIMB_MASK, FieldSpec


@functools.lru_cache(maxsize=None)
def limb_col(fs: FieldSpec, value: int, device: torch.device) -> torch.Tensor:
    """(L, 1) int64 column of the 24-bit limbs of ``value`` on ``device``."""
    return torch.from_numpy(fs.int_to_limbs(value)).long()[:, None].to(device)


def carry(x: torch.Tensor) -> torch.Tensor:
    """Sequential carry pass: limbs 0..L-2 below 2^24, the rest left in the
    top limb (below 2^24 whenever the value is below R)."""
    x = x.clone()
    for k in range(x.shape[-2] - 1):
        x[..., k + 1, :] += x[..., k, :] >> LIMB_BITS
        x[..., k, :] &= LIMB_MASK
    return x


def columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns ``sum_{i+j=k} a_i b_j``: (..., 2L, B) int64."""
    L = a.shape[-2]
    a = a.long()
    b = b.long()
    prod = a * b[..., :1, :]
    out = torch.zeros(prod.shape[:-2] + (2 * L, prod.shape[-1]), dtype=torch.int64, device=a.device)
    out[..., :L, :] = prod
    for j in range(1, L):
        out[..., j : j + L, :] += a * b[..., j : j + 1, :]
    return out


def redc(fs: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of (..., 2L, B) columns (consumed in place):
    value ``cols / R mod p``, below ``cols / R + p``, carried into limbs."""
    L = fs.nlimbs
    p = limb_col(fs, fs.modulus, cols.device)
    n0 = fs.n0inv
    for i in range(L):
        q = ((cols[..., i, :] & LIMB_MASK) * n0) & LIMB_MASK
        cols[..., i : i + L, :] += q.unsqueeze(-2) * p
        cols[..., i + 1, :] += cols[..., i, :] >> LIMB_BITS
    return carry(cols[..., L:, :])


def reduce_once(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Conditional subtraction of p: carried limbs with value < 2p ->
    canonical."""
    p = limb_col(fs, fs.modulus, x.device)
    d = x - p
    borrow = torch.zeros_like(d[..., 0, :])
    for k in range(d.shape[-2]):
        v = d[..., k, :] - borrow
        borrow = (v < 0).long()
        d[..., k, :] = v & LIMB_MASK
    return torch.where((borrow == 0).unsqueeze(-2), d, x)


def canonicalize(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Exact carry plus one conditional subtraction (input value < 2p)."""
    return reduce_once(fs, carry(x.long()))


def mont_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery product ``a * b / R mod p`` (broadcasting)."""
    return reduce_once(fs, redc(fs, columns(a, b)))


def mont_dot(fs: FieldSpec, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product ``out[i] = sum_j c[i, j] * x[j]`` with the t
    products of a row summed lazily in one set of columns and ONE REDC.

    ``c``: (n, m, L, 1) Montgomery constants; ``x``: (m, L, B)."""
    cols = columns(c[:, 0], x[0])
    for j in range(1, x.shape[0]):
        cols += columns(c[:, j], x[j])
    return reduce_once(fs, redc(fs, cols))


def mont_add(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field addition of two canonical planes: carry, one conditional subtract."""
    return reduce_once(fs, carry(a.long() + b.long()))


def mont_pow(fs: FieldSpec, x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent by MSB-first square-and-multiply, run by run
    (``ladder_schedule``), as the CUDA kernels' ``pow_ladder``."""
    base = x.long()
    acc = base
    for g in ladder_schedule(exponent):
        for _ in range(abs(g)):
            acc = mont_mul(fs, acc, acc)
        if g > 0:
            acc = mont_mul(fs, acc, base)
    return acc


def _exponent_runs(exponent: int) -> tuple[list[int], int]:
    """Run-length schedule of an MSB-first square-and-multiply ladder
    (``sponge_tpu/ops/pallas_rescue.py:240``): after seeding ``acc = x`` from
    the leading 1-bit, each entry ``g`` of ``runs`` is ``g`` squarings and
    one multiply by x; ``trailing`` squarings end it (0 for odd exponents)."""
    bits = bin(exponent)[2:]
    runs: list[int] = []
    gap = 0
    for b in bits[1:]:
        gap += 1
        if b == "1":
            runs.append(gap)
            gap = 0
    return runs, gap


def ladder_schedule(exponent: int) -> list[int]:
    """``_exponent_runs`` as the one int list the CUDA kernels read: ``g > 0``
    is g squarings then a multiply by the base, ``g < 0`` is -g squarings
    alone (the trailing run).  Exactly nbits - 1 squarings and
    popcount - 1 multiplies."""
    if exponent < 1:
        raise ValueError("exponent must be >= 1")
    runs, trailing = _exponent_runs(exponent)
    return runs + ([-trailing] if trailing else [])


def fold_count(R: int, rho: int, vmax: int) -> int:
    """Top-carry folds that bring every value below the exclusive bound
    ``vmax`` under R (``sponge_tpu/ops/pallas_p2.py:70``).  One fold maps
    V = c R + lo (lo < R) to c rho + lo with rho = R mod p, which is V mod p;
    over V < vmax its worst result is max(cm rho + (vmax-1 - cm R),
    (cm-1) rho + R-1) with cm = (vmax-1) // R."""
    folds = 0
    while vmax > R:
        vmax = fold_bound(R, rho, vmax)
        folds += 1
        if folds > 16:
            raise ValueError("rho-folding does not converge for this field")
    return folds


def fold_bound(R: int, rho: int, vmax: int) -> int:
    """Exclusive bound after one fold of values below ``vmax``."""
    if vmax <= R:
        return vmax
    cm = (vmax - 1) // R
    return max(cm * rho + (vmax - 1 - cm * R), (cm - 1) * rho + R - 1) + 1


def reduce_small(fs: FieldSpec, x: torch.Tensor, vmax: int) -> torch.Tensor:
    """Limbs (not necessarily carried) of values below ``vmax`` -> canonical:
    exact carry, ``fold_count`` top-carry rho-folds to get below R, then one
    Montgomery product by R mod p (the Montgomery form of 1), below 2p."""
    rho = limb_col(fs, fs.r_mod_p, x.device)
    x = carry(x.long())
    for _ in range(fold_count(fs.r, fs.r_mod_p, vmax)):
        c = x[..., -1:, :] >> LIMB_BITS
        x[..., -1:, :] &= LIMB_MASK
        x = carry(x + c * rho)
    return mont_mul(fs, x, rho)


def to_mont(fs: FieldSpec, x_plain: torch.Tensor) -> torch.Tensor:
    """Canonical plain limbs -> Montgomery form (x * R^2 / R)."""
    return mont_mul(fs, x_plain, limb_col(fs, fs.r2_mod_p, x_plain.device))


def from_mont(fs: FieldSpec, x_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical plain limbs (x * 1 / R)."""
    return mont_mul(fs, x_mont, limb_col(fs, 1, x_mont.device))
