// Montgomery arithmetic on 24-bit limbs in 32-bit words, one field element per
// thread, shared by the port's kernels (poseidon_opt.cu, poseidon_dense.cu,
// poseidon2.cu's and gmimc.cu's limb bodies, rescue.cu, griffin.cu,
// anemoi.cu, monolith.cu, probe.cu).
//
// An element is L little-endian limbs below 2^24 in Montgomery form with
// R = 2^(24 L).  A product or a row dot product is accumulated in L 64-bit
// columns with operand-scanning REDC interleaved (one column retires per
// step), so every limb product (< 2^48) is one mul.wide.u32 and one 64-bit
// add.  A column holds at most (terms + 1) * L such products plus a carry,
// below 2^55 for every instantiated config.  All limb loops are unrolled
// except the outer loop of mont_mul_const (the constant is read from memory
// with the loop index), which kernels 5 and 7 and the probes keep;
// kernels 1, 2, 3, 4, 6 and 8 stage their constants in shared memory and run
// their constant products fully unrolled (mont_mul_staged; kernel 1's
// sparse round in poseidon_opt.cu sparse_linear).  Results are carried back into
// 24-bit limbs but only lazily reduced (value < a*b/R + p); the Python side
// (sponge_tpu_torch/ops/bounds.py) simulates each kernel's schedule and
// refuses a config whose values could reach R or end at 2p or more.
// Kernels 5, 6 and 7 square with mont_sqr and raise to long exponents with
// pow_window, whose odd-power table sits in dynamic shared memory; kernels
// 1, 2, 6 and 8 (their limb bodies) and the probe ablation raise to alpha
// with pow_sqr (mont_sqr, the t elements of a full round in lockstep, or
// one at a time at a wide state: kWideWords), kernel 3's limb body with the
// same chain and its folds (poseidon2.cu p2_sbox).  Kernels 2, 3 and 8 run
// fields that fit one or two 32-bit words (below 2^31; Goldilocks) in bodies
// of their own (words.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sponge {

constexpr int kLimbBits = 24;
constexpr uint32_t kLimbMask = (1u << kLimbBits) - 1u;
constexpr int kThreads = 128;

template <int L>
struct Modulus {
  uint32_t p[L];
  uint32_t n0inv;  // -p^{-1} mod 2^24
};

// The constant buffer is read at the same address by every thread of a warp,
// so loads are broadcasts through the read-only cache.
__device__ __forceinline__ uint32_t ldc(const int32_t* __restrict__ c) {
  return static_cast<uint32_t>(__ldg(c));
}

// Where a routine reads the constant buffer: the read-only global path, or
// shared memory the kernel staged the buffer in (kernels 1, 2, 3, 4, 6 and 8
// and the probe ablation).  A word read from shared memory lands in an ordinary
// register; one read from global memory at a warp-uniform address may be
// kept in a uniform register, and an IMAD.WIDE.U32 with a uniform operand
// takes no 64-bit addend, so a modulus held that way costs every REDC
// product an IADD3 pair (kernel 1: PERF.md).
struct FromGlobal {
  __device__ __forceinline__ static uint32_t load(const int32_t* __restrict__ c) { return ldc(c); }
};
struct FromShared {
  __device__ __forceinline__ static uint32_t load(const int32_t* __restrict__ c) {
    return static_cast<uint32_t>(*c);
  }
};

// Copies ``words`` of the constant buffer to ``staged``, the block's dynamic
// shared memory (the whole block must reach it).
__device__ __forceinline__ void stage_constants(int32_t* staged, const int32_t* __restrict__ consts,
                                                int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) staged[i] = __ldg(consts + i);
  __syncthreads();
}

template <typename Src = FromGlobal, int L>
__device__ __forceinline__ void load_modulus(Modulus<L>& m, const int32_t* __restrict__ p,
                                             uint32_t n0inv) {
#pragma unroll
  for (int k = 0; k < L; ++k) m.p[k] = Src::load(p + k);
  m.n0inv = n0inv;
}

// One REDC step: acc[k] holds column i + k; clear column i with q * p and
// shift its carry into column i + 1.
template <int L>
__device__ __forceinline__ void redc_step(uint64_t (&acc)[L], const Modulus<L>& m) {
  const uint32_t q = ((static_cast<uint32_t>(acc[0]) & kLimbMask) * m.n0inv) & kLimbMask;
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(q) * m.p[k];
  const uint64_t carry = acc[0] >> kLimbBits;
#pragma unroll
  for (int k = 0; k < L - 1; ++k) acc[k] = acc[k + 1];
  acc[L - 1] = 0;
  acc[0] += carry;
}

template <int L>
__device__ __forceinline__ void carry_out(uint32_t (&out)[L], const uint64_t (&acc)[L]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < L - 1; ++k) {
    const uint64_t v = acc[k] + c;
    out[k] = static_cast<uint32_t>(v) & kLimbMask;
    c = v >> kLimbBits;
  }
  out[L - 1] = static_cast<uint32_t>(acc[L - 1] + c);  // < 2^24 while value < R
}

// out = a * b / R (mod p); out may alias a or b.
template <int L>
__device__ __forceinline__ void mont_mul(uint32_t (&out)[L], const uint32_t (&a)[L],
                                         const uint32_t (&b)[L], const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t bi = b[i];
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(a[k]) * bi;
    redc_step(acc, m);
  }
  carry_out(out, acc);
}

// out = a * c / R (mod p) with c an element of the constant buffer.
template <int L>
__device__ __forceinline__ void mont_mul_const(uint32_t (&out)[L], const uint32_t (&a)[L],
                                               const int32_t* __restrict__ c,
                                               const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    const uint32_t ci = ldc(c + i);
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(a[k]) * ci;
    redc_step(acc, m);
  }
  carry_out(out, acc);
}

// out = a * c / R (mod p) with c an element of the constants staged in
// shared memory, fully unrolled (the constant's limbs are read into
// registers first): kernels 3, 6 and 8.
template <int L>
__device__ __forceinline__ void mont_mul_staged(uint32_t (&out)[L], const uint32_t (&a)[L],
                                                const int32_t* c, const Modulus<L>& m) {
  uint32_t cr[L];
#pragma unroll
  for (int k = 0; k < L; ++k) cr[k] = FromShared::load(c + k);
  mont_mul(out, a, cr, m);
}

// out = (sum_j x[j] * c[j]) / R (mod p): one matrix row against the whole
// state, the T products summed lazily in the same columns, one REDC.
// c points at T constants of L limbs each.
template <int T, int L, typename Src = FromGlobal>
__device__ __forceinline__ void mont_row(uint32_t (&out)[L], const uint32_t (&x)[T][L],
                                         const int32_t* __restrict__ c, const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t cji = Src::load(c + j * L + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(x[j][k]) * cji;
    }
    redc_step(acc, m);
  }
  carry_out(out, acc);
}

// x = M x for a t x t matrix of the constant buffer (row-major, L limbs each).
template <int T, int L, typename Src = FromGlobal>
__device__ __forceinline__ void mat_apply(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                          const Modulus<L>& m) {
  uint32_t y[T][L];
#pragma unroll
  for (int i = 0; i < T; ++i) mont_row<T, L, Src>(y[i], x, mat + i * T * L, m);
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
}

// States of more than kWideWords words a lane (the ~255-bit fields at
// t >= 4: 44 to 99 words; ops/montgomery.py WIDE_WORDS) take the wide
// schedule of kernels 1, 2, 3, 5 and 7, whose live set is the state and one
// element's working words: the S-boxes one element (kernel 7: one Flystel
// pair) at a time, the MDS rows in a rolled loop (mat_apply_rows), kernel
// 1's sparse round one element at a time (poseidon_opt.cu
// sparse_linear_wide).  Every product and carry is the lockstep schedule's,
// so the words are the same; only the order differs.
constexpr int kWideWords = 40;

template <int T, int L>
constexpr bool kWideState = T * L > kWideWords;

// x[e] = x[e + 1] for e < T - 1, then x[T - 1] = v: register moves only.  A
// rolled loop of T steps that each take x[0] (or write a new row) and shift
// the result in at the top leaves x in its order with every element done,
// and no register is indexed at run time: kernels 5 and 7's wide S-boxes
// (mat_apply_rows shifts its rows in the same way).
template <int T, int L>
__device__ __forceinline__ void shift_in(uint32_t (&x)[T][L], const uint32_t (&v)[L]) {
#pragma unroll
  for (int e = 0; e + 1 < T; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) x[e][k] = x[e + 1][k];
#pragma unroll
  for (int k = 0; k < L; ++k) x[T - 1][k] = v[k];
}

// x = M x with mat_apply's rows, one row at a time in a rolled loop, so one
// row's code is inlined, not T.  Each row is shifted in at the top of y
// (y[e] = y[e + 1], then y[T - 1] = the row): after T rows y[i] holds row i
// and no register is indexed at run time.
template <int T, int L, typename Src = FromGlobal>
__device__ __forceinline__ void mat_apply_rows(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                               const Modulus<L>& m) {
  uint32_t y[T][L] = {};
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int e = 0; e + 1 < T; ++e)
#pragma unroll
      for (int k = 0; k < L; ++k) y[e][k] = y[e + 1][k];
    mont_row<T, L, Src>(y[T - 1], x, mat + i * T * L, m);
  }
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
}

// x = M x for kernels 1 and 2: mat_apply, or at a wide state mat_apply_rows.
template <int T, int L, typename Src = FromGlobal>
__device__ __forceinline__ void mds_apply(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                          const Modulus<L>& m) {
  if constexpr (kWideState<T, L>)
    mat_apply_rows<T, L, Src>(x, mat, m);
  else
    mat_apply<T, L, Src>(x, mat, m);
}

// x += y, carried into 24-bit limbs, not reduced (value stays < R by the
// static bound).
template <int L>
__device__ __forceinline__ void add_lazy(uint32_t (&x)[L], const uint32_t (&y)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < L - 1; ++k) {
    const uint32_t v = x[k] + y[k] + c;
    x[k] = v & kLimbMask;
    c = v >> kLimbBits;
  }
  x[L - 1] += y[L - 1] + c;
}

template <typename Src = FromGlobal, int L>
__device__ __forceinline__ void add_const(uint32_t (&x)[L], const int32_t* __restrict__ c) {
  uint32_t y[L];
#pragma unroll
  for (int k = 0; k < L; ++k) y[k] = Src::load(c + k);
  add_lazy(x, y);
}

// One carry pass over deferred limb words (each below 2^32 minus a carry):
// limbs 0..L-2 below 2^24, the whole excess in the top word.
template <int L>
__device__ __forceinline__ void carry_pass(uint32_t (&x)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < L - 1; ++k) {
    const uint32_t v = x[k] + c;
    x[k] = v & kLimbMask;
    c = v >> kLimbBits;
  }
  x[L - 1] += c;
}

// One top-carry rho-fold of a carried value: c = value / R leaves as
// c * (rho - R) with rho = R mod p (plain limbs, staged in shared memory),
// which keeps the value mod p and brings it toward R.  ops/bounds.py p2_plan
// counts the folds each site needs and bounds c * rho_k below 2^32.
template <int L>
__device__ __forceinline__ void fold_once(uint32_t (&x)[L], const int32_t* rho) {
  const uint32_t c = x[L - 1] >> kLimbBits;
  x[L - 1] &= kLimbMask;
  uint32_t y[L];
#pragma unroll
  for (int k = 0; k < L; ++k) y[k] = c * FromShared::load(rho + k);
  add_lazy(x, y);
}

// n <= MAX rho-folds, n warp-uniform: MAX unrolled folds, each behind a
// uniform branch, so no fold loop runs.
template <int MAX, int L>
__device__ __forceinline__ void fold_upto(uint32_t (&x)[L], const int32_t* rho, int n) {
#pragma unroll
  for (int f = 0; f < MAX; ++f)
    if (f < n) fold_once(x, rho);
}

// x = E x for a t x t matrix of small non-negative integers (plain int32 in
// the constant buffer), limb by limb in 32-bit words: no carry, no REDC.
template <int T, int L, typename Src = FromGlobal>
__device__ __forceinline__ void small_mat_apply(uint32_t (&x)[T][L],
                                                const int32_t* __restrict__ mat) {
  uint32_t y[T][L];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int k = 0; k < L; ++k) y[i][k] = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t e = Src::load(mat + i * T + j);
#pragma unroll
      for (int k = 0; k < L; ++k) y[i][k] += e * x[j][k];
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
}

// out = a^2 / R (mod p), equal word for word to mont_mul(out, a, a, m): the
// same operand-scanning frame (acc[k] holds column i + k), where row i adds
// a_i * a_i into column 2i and a_k * 2 a_i into column i + k for k > i, so
// each cross product is formed once: L (L + 1) / 2 + L^2 limb products with
// the REDC, 187 at L = 11 against mont_mul's 242.  Column c has every term
// (rows i <= c / 2) before it retires at step c, so every q and every carry
// equal mont_mul's.  A carried input keeps the doubled limb below 2^25 and
// its products below 2^49 (ops/bounds.py sqr_column_bound).  out may alias a.
template <int L>
__device__ __forceinline__ void mont_sqr(uint32_t (&out)[L], const uint32_t (&a)[L],
                                         const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a[i], di = a[i] << 1;
    acc[i] += static_cast<uint64_t>(ai) * ai;
#pragma unroll
    for (int k = i + 1; k < L; ++k) acc[k] += static_cast<uint64_t>(a[k]) * di;
    redc_step(acc, m);
  }
  carry_out(out, acc);
}

// x^alpha on N elements in lockstep by MSB-first square-and-multiply over
// the bits of alpha (a runtime value: any PoseidonConfig's alpha runs),
// squaring with mont_sqr: kernel 1's S-box (N = t in a full round below
// kWideWords words, else one element at a time; element 0 alone in a partial
// round), kernel 2's limb body's and the probe ablation's.  The bit loop
// stays rolled, so the chain inlines one squaring and one multiply per
// element.  The words equal those of the same chain squaring with mont_mul.
template <int N, int L>
__device__ __forceinline__ void pow_sqr(uint32_t (&x)[N][L], uint32_t alpha, const Modulus<L>& m) {
  uint32_t base[N][L];
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) base[e][k] = x[e][k];
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
#pragma unroll
    for (int e = 0; e < N; ++e) mont_sqr(x[e], x[e], m);
    if ((alpha >> bit) & 1u) {
#pragma unroll
      for (int e = 0; e < N; ++e) mont_mul(x[e], x[e], base[e], m);
    }
  }
}

// pow_sqr on one element.
template <int L>
__device__ __forceinline__ void pow_sqr1(uint32_t (&x)[L], uint32_t alpha, const Modulus<L>& m) {
  pow_sqr<1, L>(reinterpret_cast<uint32_t(&)[1][L]>(x), alpha, m);
}

// Dynamic shared memory of one block's pow_window tables: the odd powers
// x^3 .. x^(2^w - 1) of ``chains`` elements of L words per thread
// (ops/montgomery.py window_table_bytes).
constexpr size_t window_table_bytes(int chains, int L, int w) {
  return static_cast<size_t>(chains) * ((1 << (w - 1)) - 1) * L * sizeof(uint32_t) * kThreads;
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory where that passes
// the default 48 KB; returns the CUDA error of a refusal, else 0.
template <typename Kernel>
inline int allow_dynamic_shared(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Slot of odd power j >= 1 (x^(2j+1)) of element e in pow_window's table:
// limb k at k kThreads words past it.
template <int L>
__device__ __forceinline__ uint32_t* window_slot(uint32_t* table, int e, int entries, int j) {
  return table + (e * (entries - 1) + j - 1) * L * kThreads;
}

// dst = odd power j of an element: x1, the element itself, for j = 0, else
// its slot in pow_window's table.
template <int L>
__device__ __forceinline__ void window_entry(uint32_t (&dst)[L], const uint32_t (&x1)[L],
                                             uint32_t* table, int e, int entries, int j) {
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < L; ++k) dst[k] = x1[k];
  } else {
    const uint32_t* slot = window_slot<L>(table, e, entries, j);
#pragma unroll
    for (int k = 0; k < L; ++k) dst[k] = slot[k * kThreads];
  }
}

// x^e on N elements in lockstep by a left-to-right sliding window of w bits
// (ops/montgomery.py window_schedule): ``sched`` holds the table index j of
// the leading window (x^(2j+1) seeds the accumulator), then per further
// window (squarings, j), j = -1 for squarings alone; it is read by loop
// index through Src (global or staged), a warp-uniform broadcast.  The odd powers x^3 .. x^(2^w - 1) of
// each element sit in this thread's slots of dynamic shared memory
// (``table`` = the block's table + threadIdx.x, limbs kThreads words apart,
// so a warp's 32 accesses fall in 32 banks); x itself stays in registers.
// The table is built by the chain's own loop bodies, so each element
// inlines one mont_sqr and one mont_mul: step 0 squares x and parks x^2 in the
// last slot, step 1 multiplies by x (x^3), steps 2 .. E-1 by the parked x^2
// (E = 2^(w-1) entries), each storing its power; the last reads x^2 before
// it overwrites it with x^(2E-1).  One squaring and E - 1 multiplies build
// the table; ops/bounds.py _Replay.pow_window replays this order.
template <int N, int L, typename Src = FromGlobal>
__device__ __forceinline__ void pow_window(uint32_t (&x)[N][L], const int32_t* __restrict__ sched,
                                           int n_sched, int w, uint32_t* table,
                                           const Modulus<L>& m) {
  const int entries = 1 << (w - 1);
  const int steps = (n_sched - 1) / 2;
  uint32_t base[N][L];
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) base[e][k] = x[e][k];
#pragma unroll 1
  for (int s = entries > 1 ? -entries : 0;; ++s) {
    int squarings, j, store = 0;
    if (s < 0) {  // table step
      const int k = s + entries;
      squarings = k == 0;
      j = k == 0 ? -1 : (k == 1 ? 0 : entries - 1);
      store = k == 0 ? entries - 1 : k;
    } else {
      if (s == 0) {
        const int seed = static_cast<int>(Src::load(sched));
#pragma unroll
        for (int e = 0; e < N; ++e) window_entry(x[e], base[e], table, e, entries, seed);
      }
      if (s == steps) break;
      squarings = static_cast<int>(Src::load(sched + 1 + 2 * s));
      j = static_cast<int>(Src::load(sched + 2 + 2 * s));
    }
#pragma unroll 1
    for (int r = 0; r < squarings; ++r) {
#pragma unroll
      for (int e = 0; e < N; ++e) mont_sqr(x[e], x[e], m);
    }
    if (j >= 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        uint32_t op[L];
        window_entry(op, base[e], table, e, entries, j);
        mont_mul(x[e], x[e], op, m);
      }
    }
    if (store > 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        uint32_t* slot = window_slot<L>(table, e, entries, store);
#pragma unroll
        for (int k = 0; k < L; ++k) slot[k * kThreads] = x[e][k];
      }
    }
  }
}

// Value < 2p -> canonical (< p): subtract p unless that borrows.
template <int L>
__device__ __forceinline__ void reduce_once(uint32_t (&x)[L], const Modulus<L>& m) {
  uint32_t d[L];
  int32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int32_t v = static_cast<int32_t>(x[k]) - static_cast<int32_t>(m.p[k]) - borrow;
    borrow = v < 0;
    d[k] = static_cast<uint32_t>(v) & kLimbMask;
  }
  if (!borrow) {
#pragma unroll
    for (int k = 0; k < L; ++k) x[k] = d[k];
  }
}

// (t, L, B) plane <-> registers: thread b reads limb k of element e at
// (e * L + k) * B + b, so a warp's loads and stores are coalesced.
template <int T, int L>
__device__ __forceinline__ void load_state(uint32_t (&x)[T][L], const int32_t* __restrict__ in,
                                           long long B, long long b) {
#pragma unroll
  for (int e = 0; e < T; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) x[e][k] = static_cast<uint32_t>(in[(e * L + k) * B + b]);
}

template <int T, int L>
__device__ __forceinline__ void store_state(int32_t* __restrict__ out, uint32_t (&x)[T][L],
                                            long long B, long long b, const Modulus<L>& m) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    reduce_once(x[e], m);
#pragma unroll
    for (int k = 0; k < L; ++k) out[(e * L + k) * B + b] = static_cast<int32_t>(x[e][k]);
  }
}


static_assert(kLimbBits == 24, "the Python side assumes 24-bit limbs");

}  // namespace sponge
