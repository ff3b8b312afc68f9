// Montgomery arithmetic on 24-bit limbs in 32-bit words, one field element per
// thread, shared by the port's kernels (poseidon_opt.cu, poseidon_dense.cu,
// poseidon2.cu, rescue.cu, gmimc.cu, griffin.cu, anemoi.cu, monolith.cu,
// probe.cu).
//
// An element is L little-endian limbs below 2^24 in Montgomery form with
// R = 2^(24 L).  A product or a row dot product is accumulated in L 64-bit
// columns with operand-scanning REDC interleaved (one column retires per
// step), so every limb product (< 2^48) is one mul.wide.u32 and one 64-bit
// add.  A column holds at most (terms + 1) * L such products plus a carry,
// below 2^55 for every instantiated config.  All limb loops are unrolled
// except the outer loop of mont_mul_const (the constant is read from memory
// with the loop index): unrolling that one too made nvcc 12.9's device front
// end (cicc) crash on the sparse-round kernel at L = 11.  Results are carried back into
// 24-bit limbs but only lazily reduced (value < a*b/R + p); the Python side
// (sponge_tpu_torch/ops/bounds.py) simulates each kernel's schedule and
// refuses a config whose values could reach R or end at 2p or more.
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

template <int L>
__device__ __forceinline__ void load_modulus(Modulus<L>& m, const int32_t* __restrict__ p,
                                             uint32_t n0inv) {
#pragma unroll
  for (int k = 0; k < L; ++k) m.p[k] = ldc(p + k);
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

// out = (sum_j x[j] * c[j]) / R (mod p): one matrix row against the whole
// state, the T products summed lazily in the same columns, one REDC.
// c points at T constants of L limbs each.
template <int T, int L>
__device__ __forceinline__ void mont_row(uint32_t (&out)[L], const uint32_t (&x)[T][L],
                                         const int32_t* __restrict__ c, const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t cji = ldc(c + j * L + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(x[j][k]) * cji;
    }
    redc_step(acc, m);
  }
  carry_out(out, acc);
}

// x = M x for a t x t matrix of the constant buffer (row-major, L limbs each).
template <int T, int L>
__device__ __forceinline__ void mat_apply(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                          const Modulus<L>& m) {
  uint32_t y[T][L];
#pragma unroll
  for (int i = 0; i < T; ++i) mont_row<T, L>(y[i], x, mat + i * T * L, m);
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
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

template <int L>
__device__ __forceinline__ void add_const(uint32_t (&x)[L], const int32_t* __restrict__ c) {
  uint32_t y[L];
#pragma unroll
  for (int k = 0; k < L; ++k) y[k] = ldc(c + k);
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

// n top-carry rho-folds of a carried value: c = value / R leaves as
// c * (rho - R) with rho = R mod p (plain limbs), which keeps the value mod p
// and brings it toward R.  ops/bounds.py p2_plan counts the folds each site
// needs and bounds c * rho_k below 2^32.
template <int L>
__device__ __forceinline__ void fold(uint32_t (&x)[L], const int32_t* __restrict__ rho, int n) {
#pragma unroll 1
  for (int f = 0; f < n; ++f) {
    const uint32_t c = x[L - 1] >> kLimbBits;
    x[L - 1] &= kLimbMask;
    uint32_t y[L];
#pragma unroll
    for (int k = 0; k < L; ++k) y[k] = c * ldc(rho + k);
    add_lazy(x, y);
  }
}

// x = E x for a t x t matrix of small non-negative integers (plain int32 in
// the constant buffer), limb by limb in 32-bit words: no carry, no REDC.
template <int T, int L>
__device__ __forceinline__ void small_mat_apply(uint32_t (&x)[T][L],
                                                const int32_t* __restrict__ mat) {
  uint32_t y[T][L];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int k = 0; k < L; ++k) y[i][k] = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t e = ldc(mat + i * T + j);
#pragma unroll
      for (int k = 0; k < L; ++k) y[i][k] += e * x[j][k];
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
}

// x^alpha by MSB-first square-and-multiply over the bits of alpha.
template <int L>
__device__ __forceinline__ void mont_pow(uint32_t (&x)[L], uint32_t alpha, const Modulus<L>& m) {
  uint32_t base[L];
#pragma unroll
  for (int k = 0; k < L; ++k) base[k] = x[k];
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
    mont_mul(x, x, x, m);
    if ((alpha >> bit) & 1u) mont_mul(x, x, base, m);
  }
}

// x^e by the run-length ladder (ops/montgomery.py ladder_schedule) on N
// elements in lockstep: entry g > 0 of the schedule is g squarings and one
// multiply by the element's input, g < 0 is -g squarings.  The schedule is
// read by loop index (a warp-uniform broadcast) and both loops stay rolled,
// so a 254-bit exponent costs one inlined squaring and one multiply body per
// element.  Each product is followed by ``folds`` rho-folds (see fold()).
template <int N, int L>
__device__ __forceinline__ void pow_ladder(uint32_t (&x)[N][L], const int32_t* __restrict__ runs,
                                           int n_runs, const Modulus<L>& m,
                                           const int32_t* __restrict__ rho, int folds) {
  uint32_t base[N][L];
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) base[e][k] = x[e][k];
#pragma unroll 1
  for (int i = 0; i < n_runs; ++i) {
    const int g = __ldg(runs + i);
    const int squarings = g < 0 ? -g : g;
#pragma unroll 1
    for (int s = 0; s < squarings; ++s) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        mont_mul(x[e], x[e], x[e], m);
        fold(x[e], rho, folds);
      }
    }
    if (g > 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        mont_mul(x[e], x[e], base[e], m);
        fold(x[e], rho, folds);
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

// A full round: ARK, x^alpha on every element, dense MDS.
template <int T, int L>
__device__ __forceinline__ void full_round(uint32_t (&x)[T][L], const int32_t* __restrict__ ark_r,
                                           const int32_t* __restrict__ mds, uint32_t alpha,
                                           const Modulus<L>& m) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    add_const(x[e], ark_r + e * L);
    mont_pow(x[e], alpha, m);
  }
  mat_apply<T, L>(x, mds, m);
}

static_assert(kLimbBits == 24, "the Python side assumes 24-bit limbs");

}  // namespace sponge
