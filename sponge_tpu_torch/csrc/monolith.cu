// Kernel 4: the Monolith permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_monolith.py (monolith_kernel_fn, bodies
// _monolith_kernel and _monolith_kernel_mersenne).  Schedule (ePrint
// 2023/1025): Concrete, then per round
//     Bars     on x_0..x_{u-1}: chi-like S-boxes on the canonical bit chunks;
//     Bricks   x_i += x_{i-1}^2 for i = t-1 down to 1 (squares of the values
//              before the update);
//     Concrete x <- M x, then x += rc[round] (the last row is zero);
// then a canonical output plane.
//
// Two bodies; ops/bounds.py check_monolith_bounds picks one per config and
// derives its fold counts by replaying it on value and word bounds:
//
// * Generic (Goldilocks, KoalaBear, BabyBear): Montgomery limbs as every
//   other kernel.  Bars take a product by plain 1 (out of Montgomery form,
//   value <= p), the conditional subtraction (exact canonical bits), chi on
//   each chunk (no chunk straddles two 24-bit limbs: chunks never cross a
//   multiple of 8), and a product by R^2 mod p (back, below 2p).  Bricks
//   square with mont_mul and rho-fold the square and the sum.  The scaled
//   Concrete (every entry a positive integer below 2^24: all shipped
//   defaults) multiplies the plain entry into each 32-bit limb word and sums
//   the t terms in 64-bit columns: Goldilocks t = 12 has entries up to 2^16
//   and a row sum of 70,967, so a 24-bit limb times an entry passes 2^32
//   and the 32-bit small_mat_apply of kernel 3 would overflow; the high part
//   (value / R, below 2^17 R) is folded back through rho = R mod p in the
//   same columns (fold_cols).  The dense Concrete (a Cauchy matrix) is one
//   lazily summed Montgomery row per element (mat_apply).  Exit: a product
//   by the Montgomery form of 1 and the conditional subtraction.
// * Mersenne (p = 2^n - 1, n <= 32: Mersenne31): R mod p = 2^s (s = 17 at
//   L = 2), so the Montgomery form is the canonical value rotated left by s
//   within n bits and one canonical value fits one 32-bit word.  The body
//   rotates right by s on entry and left on exit and works on canonical
//   words in between: no Montgomery reduction anywhere.  A square, a
//   Concrete row or a sum is formed in 64 bits and reduced by 2^n = 1 folds
//   (v -> (v >> n) + (v & p)) below 2p, then by one conditional subtraction.
//   The round constants and the matrix are plain in the constant buffer.
//
// What bounds it on the H100: integer multiply-add issue (the Concrete's t^2
// L scalings and the squares), with state traffic within 4x of it.  Design:
// one thread per lane, state in registers, one rolled round loop; the
// Concrete rows are unrolled (t^2 L straight-line 64-bit multiply-adds).
//
// Constant buffer layout (int32, limb axis last; monolith/config.py
// constant_layout): p (L) | rho = R mod p (L) | plain 1 (L) | R^2 mod p (L) |
// Bar chunk widths (n_chunks) | rc (rounds, t, L) | M (t, t, L).

#include "mont.cuh"

namespace sponge {

// The chi-like k-bit S-box (monolith/config.py chunk_sbox): k <= 8, y < 2^k.
__device__ __forceinline__ uint32_t chi_chunk(uint32_t y, int k) {
  const uint32_t mask = (1u << k) - 1u;
  auto rot = [&](uint32_t v, int r) {  // r <= 3: a division only for chunks of 3 bits or fewer
    if (r >= k) r %= k;
    return ((v << r) | (v >> (k - r))) & mask;
  };
  const uint32_t nb = y ^ mask;
  const uint32_t z = (k & 1) ? y ^ (rot(nb, 1) & rot(y, 2)) : y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3));
  return rot(z, 1);
}

// Bar of canonical plain limbs: the chunks starting in limb k end in limb k.
template <int L>
__device__ __forceinline__ void bar_limbs(uint32_t (&x)[L], const int32_t* __restrict__ chunks,
                                          int n_chunks) {
  int c = 0, bit = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint32_t limb = x[k];
    uint32_t out = 0;
#pragma unroll 1
    for (; c < n_chunks && bit < kLimbBits * (k + 1); ++c) {
      const int w = __ldg(chunks + c);
      const int off = bit - kLimbBits * k;
      out |= chi_chunk((limb >> off) & ((1u << w) - 1u), w) << off;
      bit += w;
    }
    x[k] = out;
  }
}

// 64-bit columns -> carried words, with n folds of the part at or above R:
// carry, then value = lo + H R = lo + H rho (mod p), H * rho_k added in the
// same columns.  ops/bounds.py bounds H below 2^39 and the last top word
// below 2^32.
template <int L>
__device__ __forceinline__ void fold_cols(uint32_t (&out)[L], uint64_t (&acc)[L],
                                          const int32_t* __restrict__ rho, int n) {
#pragma unroll 1
  for (int f = 0; f < n; ++f) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = acc[k] + c;
      acc[k] = v & kLimbMask;
      c = v >> kLimbBits;
    }
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += c * ldc(rho + k);
  }
  carry_out(out, acc);
}

template <int T, int L, bool SCALED>
__device__ __forceinline__ void concrete(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                         const int32_t* __restrict__ rho, int folds,
                                         const Modulus<L>& m) {
  if constexpr (SCALED) {
    uint32_t y[T][L];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint64_t acc[L];
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t c = ldc(mat + (i * T + j) * L);  // a plain entry is its own low limb
#pragma unroll
        for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(c) * x[j][k];
      }
      fold_cols(y[i], acc, rho, folds);
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
  } else {
    mat_apply<T, L>(x, mat, m);
#pragma unroll
    for (int i = 0; i < T; ++i) fold(x[i], rho, folds);
  }
}

template <int T, int L, bool SCALED>
__global__ void __launch_bounds__(kThreads)
    monolith_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                    int rounds, int bars, int n_chunks, int f_sq, int f_add, int f_conc, int f_rc,
                    const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* rho = consts + L;
  const int32_t* one = rho + L;
  const int32_t* r2 = one + L;
  const int32_t* chunks = r2 + L;
  const int32_t* rc = chunks + n_chunks;
  const int32_t* mat = rc + rounds * T * L;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  concrete<T, L, SCALED>(x, mat, rho, f_conc, m);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) {
      if (e < bars) {
        mont_mul_const(x[e], x[e], one, m);  // out of Montgomery form: value <= p
        reduce_once(x[e], m);
        bar_limbs(x[e], chunks, n_chunks);
        mont_mul_const(x[e], x[e], r2, m);
      }
    }
#pragma unroll
    for (int i = T - 1; i >= 1; --i) {  // x_{i-1} is still the pre-update value
      uint32_t sq[L];
      mont_mul(sq, x[i - 1], x[i - 1], m);
      fold(sq, rho, f_sq);
      add_lazy(x[i], sq);
      fold(x[i], rho, f_add);
    }
    concrete<T, L, SCALED>(x, mat, rho, f_conc, m);
#pragma unroll
    for (int e = 0; e < T; ++e) {
      add_const(x[e], rc + (r * T + e) * L);
      fold(x[e], rho, f_rc);
    }
  }
#pragma unroll
  for (int e = 0; e < T; ++e) mont_mul_const(x[e], x[e], rho, m);  // rho is the Montgomery form of 1
  store_state<T, L>(out, x, B, b, m);
}

// ---- the Mersenne body: one canonical word per element ----

template <int L>
__device__ __forceinline__ uint32_t ld_word(const int32_t* __restrict__ c) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) v |= ldc(c + k) << (kLimbBits * k);
  return v;
}

// v < 2^64 -> canonical, by ``folds`` 2^n = 1 folds (then below 2p) and one
// conditional subtraction.
__device__ __forceinline__ uint32_t mersenne_reduce(uint64_t v, int folds, int n, uint32_t p) {
#pragma unroll 1
  for (int f = 0; f < folds; ++f) v = (v >> n) + (v & p);
  const uint32_t w = static_cast<uint32_t>(v);
  return w >= p ? w - p : w;
}

// Rotate left by s within n bits (v < 2^n).
__device__ __forceinline__ uint32_t rotl_bits(uint32_t v, int s, int n, uint32_t p) {
  const uint64_t w = v;
  return static_cast<uint32_t>(((w << s) | (w >> (n - s))) & p);
}

template <int T, int L>
__device__ __forceinline__ void concrete_words(uint32_t (&x)[T], const int32_t* __restrict__ mat,
                                               int folds, int n, uint32_t p) {
  uint32_t y[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) acc += static_cast<uint64_t>(ld_word<L>(mat + (i * T + j) * L)) * x[j];
    y[i] = mersenne_reduce(acc, folds, n, p);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = y[i];
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    monolith_mersenne_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                             int rounds, int bars, int n_chunks, int f_sq, int f_add, int f_conc,
                             int f_rc, int n, int s, const int32_t* __restrict__ consts) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t p = ld_word<L>(consts);
  const int32_t* chunks = consts + 4 * L;
  const int32_t* rc = chunks + n_chunks;
  const int32_t* mat = rc + rounds * T * L;

  uint32_t x[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) v |= static_cast<uint32_t>(in[(e * L + k) * B + b]) << (kLimbBits * k);
    x[e] = rotl_bits(v, n - s, n, p);  // Montgomery form -> canonical: rotate right by s
  }
  concrete_words<T, L>(x, mat, f_conc, n, p);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) {
      if (e < bars) {
        uint32_t o = 0;
        int bit = 0;
#pragma unroll 1
        for (int c = 0; c < n_chunks; ++c) {
          const int w = __ldg(chunks + c);
          o |= chi_chunk((x[e] >> bit) & ((1u << w) - 1u), w) << bit;
          bit += w;
        }
        x[e] = o;
      }
    }
#pragma unroll
    for (int i = T - 1; i >= 1; --i) {
      const uint32_t sq = mersenne_reduce(static_cast<uint64_t>(x[i - 1]) * x[i - 1], f_sq, n, p);
      x[i] = mersenne_reduce(static_cast<uint64_t>(x[i]) + sq, f_add, n, p);
    }
    concrete_words<T, L>(x, mat, f_conc, n, p);
#pragma unroll
    for (int e = 0; e < T; ++e)
      x[e] = mersenne_reduce(static_cast<uint64_t>(x[e]) + ld_word<L>(rc + (r * T + e) * L), f_rc, n, p);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint32_t v = rotl_bits(x[e], s, n, p);  // canonical -> Montgomery form
#pragma unroll
    for (int k = 0; k < L; ++k)
      out[(e * L + k) * B + b] = static_cast<int32_t>(k < L - 1 ? (v >> (kLimbBits * k)) & kLimbMask
                                                               : v >> (kLimbBits * k));
  }
}

template <int T, int L>
int launch_monolith(const int32_t* in, int32_t* out, long long B, int rounds, int bars,
                    int n_chunks, int mersenne, int scaled, const int* plan,
                    const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  if (mersenne) {
    if constexpr (L <= 2) {  // n <= 32 bits: at most two 24-bit limbs
      monolith_mersenne_kernel<T, L><<<blocks, kThreads, 0, stream>>>(
          in, out, B, rounds, bars, n_chunks, plan[0], plan[1], plan[2], plan[3], plan[4],
          plan[5], consts);
    } else {
      return -1;
    }
  } else if (scaled) {
    monolith_kernel<T, L, true><<<blocks, kThreads, 0, stream>>>(
        in, out, B, rounds, bars, n_chunks, plan[0], plan[1], plan[2], plan[3], consts, n0inv);
  } else {
    monolith_kernel<T, L, false><<<blocks, kThreads, 0, stream>>>(
        in, out, B, rounds, bars, n_chunks, plan[0], plan[1], plan[2], plan[3], consts, n0inv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  ``plan`` (host memory) holds the
// fold counts of ops/bounds.py MONOLITH_SITES, the bit length n and the
// Mersenne shift s.  Instantiations must match INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_monolith(const int32_t* in, int32_t* out, long long B, int t, int L,
                               int rounds, int bars, int n_chunks, int mersenne, int scaled,
                               const int* plan, const int32_t* consts, unsigned n0inv,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 12 && L == 3)
    return sponge::launch_monolith<12, 3>(in, out, B, rounds, bars, n_chunks, mersenne, scaled,
                                          plan, consts, n0inv, s);
  if (t == 8 && L == 3)
    return sponge::launch_monolith<8, 3>(in, out, B, rounds, bars, n_chunks, mersenne, scaled,
                                         plan, consts, n0inv, s);
  if (t == 16 && L == 2)
    return sponge::launch_monolith<16, 2>(in, out, B, rounds, bars, n_chunks, mersenne, scaled,
                                          plan, consts, n0inv, s);
  if (t == 4 && L == 2)
    return sponge::launch_monolith<4, 2>(in, out, B, rounds, bars, n_chunks, mersenne, scaled,
                                         plan, consts, n0inv, s);
  return -1;
}
