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

The exponent schedules also live here: the run-length ladder
(``ladder_schedule``: ``mont_pow`` and the replays of the kernels' square-
and-multiply chains) and the sliding window (``window_schedule``, kernels 5,
6 and 7), with the rule that picks a kernel's window (``window_for``).
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
    top limb (below 2^24 whenever the value is below R).  The limb rows are
    separate tensors, so a step is three element-wise ops."""
    rows = list(x.long().unbind(-2))
    for k in range(len(rows) - 1):
        c = rows[k] >> LIMB_BITS
        rows[k] = rows[k] & LIMB_MASK
        rows[k + 1] = rows[k + 1] + c
    return torch.stack(rows, -2)


@functools.lru_cache(maxsize=None)
def _diagonal(L: int, device: torch.device) -> torch.Tensor:
    """Column i + j of each limb product a_i b_j, in the order of the flattened
    (j, i) outer product."""
    return torch.tensor([i + j for j in range(L) for i in range(L)], device=device)


def columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns ``sum_{i+j=k} a_i b_j``: (..., 2L, B) int64,
    from one outer product of the limbs and one indexed sum."""
    L = a.shape[-2]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    outer = a.long().unsqueeze(-3) * b.long().unsqueeze(-2)  # [..., j, i, :] = a_i b_j
    out = torch.zeros(shape[:-2] + (2 * L, shape[-1]), dtype=torch.int64, device=a.device)
    return out.index_add_(-2, _diagonal(L, a.device), outer.reshape(shape[:-2] + (L * L, shape[-1])))


def redc(fs: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of (..., 2L, B) columns (consumed in place):
    value ``cols / R mod p``, below ``cols / R + p``, carried into limbs."""
    L = fs.nlimbs
    p = limb_col(fs, fs.modulus, cols.device)
    n0 = fs.n0inv
    rows = cols.unbind(-2)  # views: in-place ops on a row write to cols
    for i in range(L):
        q = ((rows[i] & LIMB_MASK) * n0) & LIMB_MASK
        cols[..., i : i + L, :].addcmul_(q.unsqueeze(-2), p)
        rows[i + 1].add_(rows[i] >> LIMB_BITS)
    return carry(cols[..., L:, :])


def reduce_once(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Conditional subtraction of p: carried limbs with value < 2p ->
    canonical.  The borrow of each limb of x - p is its floor shift (-1 or
    0); a negative top limb means x < p."""
    rows = (x - limb_col(fs, fs.modulus, x.device)).unbind(-2)
    out, v = [], None
    for r in rows:
        v = r if v is None else r + (v >> LIMB_BITS)
        out.append(v & LIMB_MASK)
    return torch.where((v < 0).unsqueeze(-2), x, torch.stack(out, -2))


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
    """x^exponent of a canonical plane by MSB-first square-and-multiply, run
    by run (``ladder_schedule``), as the CUDA kernels' ``mont_pow``.  The
    limb plan leaves R >= 16p (at least 4 bits of headroom), so a product
    of two values below 2p stays below 4p^2 / R + p < 2p: the chain keeps
    its products carried but unreduced and reduces the result once (a
    quarter fewer tensor ops a product than ``mont_mul``)."""
    base = x.long()
    acc = base
    for g in ladder_schedule(exponent):
        for _ in range(abs(g)):
            acc = redc(fs, columns(acc, acc))
        if g > 0:
            acc = redc(fs, columns(acc, base))
    return reduce_once(fs, acc)


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


def window_schedule(exponent: int, w: int) -> list[int]:
    """Left-to-right sliding-window chain of x^exponent over the odd powers
    x, x^3, ..., x^(2^w - 1) (table index j is x^(2j+1)), as the one int
    list ``pow_window`` (``csrc/mont.cuh``) reads: the table index of the
    leading window, which seeds the accumulator, then a pair per further
    window, the squarings before its multiply (the zero bits since the last
    window plus its own length) and its table index; trailing zero bits end
    it as a pair with index -1 (squarings alone).  Each window is at most w
    bits and ends in a 1-bit.  w = 1 is square-and-multiply."""
    if exponent < 1 or w < 1:
        raise ValueError("exponent and w must be >= 1")
    bits = bin(exponent)[2:]

    def window(i):  # [i, j) and its value, from the 1-bit at i
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        return j, int(bits[i:j], 2)

    i, top = window(0)
    out, zeros = [top >> 1], 0
    while i < len(bits):
        if bits[i] == "0":
            zeros, i = zeros + 1, i + 1
            continue
        j, value = window(i)
        out += [zeros + j - i, value >> 1]
        zeros, i = 0, j
    return out + ([zeros, -1] if zeros else [])


def window_counts(exponent: int, w: int) -> tuple[int, int]:
    """(squarings, multiplies) of ``pow_window`` at window w, the table
    included: one squaring for x^2 and 2^(w-1) - 1 multiplies where w > 1."""
    sched = window_schedule(exponent, w)
    squarings, muls = sum(sched[1::2]), sum(j >= 0 for j in sched[2::2])
    if w > 1:
        squarings, muls = squarings + 1, muls + (1 << (w - 1)) - 1
    return squarings, muls


# csrc/mont.cuh kWideWords: a state of more words a lane takes the kernels'
# wide schedule (kernels 5 and 7: one element or Flystel pair at a time, so
# one window chain, not t or l).
WIDE_WORDS = 40


def wide_state(t: int, L: int) -> bool:
    """csrc/mont.cuh kWideState: more than ``WIDE_WORDS`` words a lane."""
    return t * L > WIDE_WORDS


# The H100's limits that decide how many 128-thread blocks an SM holds.
THREADS = 128  # csrc/mont.cuh kThreads
SM_REGISTERS, SM_SHARED, BLOCK_RESERVED, SM_THREADS, SM_BLOCKS = 65536, 233472, 1024, 2048, 32


def window_table_bytes(chains: int, L: int, w: int) -> int:
    """Dynamic shared memory of one block's odd-power tables: x^3 .. x^(2^w - 1)
    of every chain, L words each, per thread (x itself stays in registers);
    ``csrc/mont.cuh`` ``window_table_bytes``."""
    return chains * ((1 << (w - 1)) - 1) * L * 4 * THREADS


def blocks_per_sm(registers: int, shared_bytes: int) -> int:
    """Resident 128-thread blocks per SM at ``registers`` per thread (warps
    take registers in units of 256) and ``shared_bytes`` per block (units
    of 128 bytes, plus 1 KB the system reserves per block); 0 where the
    block does not fit."""
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = SM_REGISTERS // warp_regs // (THREADS // 32)
    by_shared = SM_SHARED // (-(-shared_bytes // 128) * 128 + BLOCK_RESERVED)
    return min(by_regs, by_shared, SM_THREADS // THREADS, SM_BLOCKS)


def window_for(exponent: int, L: int, chains: int, registers: int) -> int:
    """The window of ``pow_window`` for x^exponent on ``chains`` elements of
    L limbs per thread, in a kernel of ``registers`` per thread: the fewest
    limb products (a squaring L(L+1)/2 + L^2, a multiply 2 L^2; ties to the
    smaller table) among the windows of 1 to 8 bits whose table keeps the
    blocks per SM that the registers allow."""
    sq, mul = L * (L + 1) // 2 + L * L, 2 * L * L
    target = blocks_per_sm(registers, 0)
    costs = {}
    for w in range(1, 9):
        if blocks_per_sm(registers, window_table_bytes(chains, L, w)) >= target:
            n_sq, n_mul = window_counts(exponent, w)
            costs[w] = n_sq * sq + n_mul * mul
    return min(costs, key=costs.get)


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
