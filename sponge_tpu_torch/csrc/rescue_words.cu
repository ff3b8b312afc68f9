// Kernel 5's two-word body: the Rescue permutation of rescue.cu over
// Goldilocks (p = 2^64 - 2^32 + 1) at t = 5..12, in Rescue-Prime's order
// and in Rescue Prime Optimized's (the MDS first, template flag MdsFirst).
//
// The limb body holds a Goldilocks element in three 24-bit Montgomery limbs:
// a product is 2 L^2 = 18 widening products and a REDC carry pass, and the
// inverse S-box x^(1/7) (a 64-bit exponent with 33 ones) takes most of the
// work.  Here an element is one 64-bit word in plain form, not necessarily
// below p, as in kernel 1's two-word body (poseidon_opt_words.cu): a
// product is the four 32-bit halves' products reduced by shifts and adds
// (words.cuh gl_mul, gl_sqr).
//
// At alpha = 7, which every Goldilocks Rescue config takes (7 is the
// smallest prime prime to p - 1), x^7 is 2 squarings and 2 products on all
// t elements in lockstep, and x^(1/7) Miden's fixed addition chain
// (exp_acc), 63 squarings and 9 products against the binary chain's 63 and
// 32, run on kInvGroup elements at a time, its runs of squarings rolled
// loops over the group.  A config of another alpha runs square-and-multiply
// over the 64-bit exponents in the word buffer on all t elements, chosen by
// the uniform argument ``chain``.
//
// An MDS row is one of two sums, chosen by the uniform argument ``narrow``
// (ops/bounds.py check_rescue_gl_bounds decides): where every entry is a
// small 32-bit word (RPO's circulant: below 2^5), the low and the high
// 32-bit halves of the elements times the entries in two 64-bit
// accumulators, 2t products a row, reduced once (gl_narrow); otherwise the
// t 128-bit products in five 32-bit words (words.cuh gl_row).  The matrix
// is read through a volatile pointer so that ptxas cannot hoist its t^2
// entries into registers across the round loop.  Round constants are added
// by gl_add.
//
// Entry and exit: each element is read from the (t, 3, B) plane of
// canonical Montgomery limbs and converted to plain form by one product by
// 2^-72 mod p; on exit it is converted back by a product by 2^72 mod p and
// one conditional subtraction (gl_to_limbs), so every caller sees the plane
// the limb body gave.
//
// ops/bounds.py _RescueGLSim replays this schedule on bounds before every
// launch.  Word constant layout (int32; ops/rescue.py word_constants):
// 2^-72 mod p, 2^72 mod p, alpha, 1/alpha mod p - 1 | rc (2N, t) |
// mds (t, t), each a 64-bit plain value in two 32-bit words, low first.

#include "mont.cuh"
#include "words.cuh"

namespace sponge {

// 64-bit words at the head of the word buffer: 2^-72 and 2^72 mod p, then
// the exponents alpha and 1/alpha.
constexpr int kRescueGlHead = 4;

// x_e <- x_e^(2^K) for e in [Lo, Hi): a rolled loop of K steps, each a
// squaring of every element.
template <int K, int Lo, int Hi, int T>
__device__ __forceinline__ void gl_sqr_run(uint64_t (&x)[T]) {
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = Lo; e < Hi; ++e) x[e] = gl_sqr(x[e]);
  }
}

// x_e <- x_e y_e for e in [Lo, Hi).
template <int Lo, int Hi, int T>
__device__ __forceinline__ void gl_mul_by(uint64_t (&x)[T], const uint64_t (&y)[T]) {
#pragma unroll
  for (int e = Lo; e < Hi; ++e) x[e] = gl_mul(x[e], y[e]);
}

// x^7 on every element: x^2, x^3 = x^2 x, x^4 = (x^2)^2, x^7 = x^4 x^3.
template <int T>
__device__ __forceinline__ void gl_pow7(uint64_t (&x)[T]) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint64_t x2 = gl_sqr(x[e]);
    x[e] = gl_mul(gl_sqr(x2), gl_mul(x2, x[e]));
  }
}

// x^(1/7) = x^0x92492491b6db6db7 on elements [Lo, Hi), Miden's chain with
// x^7 = x^2 x^4 x formed first so that x, x^2 and x^4 die early: t3 =
// (x^4)^(2^3) x^4, t4 = t3^(2^6) t3, t5 = t4^(2^12) t4, t6 = t5^(2^6) t3,
// t7 = t6^(2^31) t6, then ((t7^2 t6)^4) x^7.  At most four words an element
// are live (x^7, t3, t4 and the running power).
template <int Lo, int Hi, int T>
__device__ __forceinline__ void gl_pow_inv7(uint64_t (&x)[T]) {
  uint64_t b[T], u[T], v[T];
#pragma unroll
  for (int e = Lo; e < Hi; ++e) {
    const uint64_t x2 = gl_sqr(x[e]), x4 = gl_sqr(x2);
    b[e] = gl_mul(gl_mul(x2, x4), x[e]);
    x[e] = u[e] = x4;
  }
  gl_sqr_run<3, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, u);  // t3
#pragma unroll
  for (int e = Lo; e < Hi; ++e) u[e] = x[e];
  gl_sqr_run<6, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, u);  // t4
#pragma unroll
  for (int e = Lo; e < Hi; ++e) v[e] = x[e];
  gl_sqr_run<12, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, v);  // t5
  gl_sqr_run<6, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, u);  // t6
#pragma unroll
  for (int e = Lo; e < Hi; ++e) u[e] = x[e];
  gl_sqr_run<31, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, u);  // t7
  gl_sqr_run<1, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, u);
  gl_sqr_run<2, Lo, Hi>(x);
  gl_mul_by<Lo, Hi>(x, b);
}

// Elements a run of Miden's chain raises together (gl_pow_inv7_groups): at
// Goldilocks t = 12, 3 ran 16% faster than all 12 in lockstep and 3% faster
// than two halves of 6 (PERF.md section 6).
constexpr int kInvGroup = 3;

// x^(1/7) on every element, kInvGroup elements at a time.
template <int Lo, int T>
__device__ __forceinline__ void gl_pow_inv7_groups(uint64_t (&x)[T]) {
  if constexpr (Lo < T) {
    constexpr int Hi = Lo + kInvGroup < T ? Lo + kInvGroup : T;
    gl_pow_inv7<Lo, Hi>(x);
    gl_pow_inv7_groups<Hi, T>(x);
  }
}

// x^e on every element for any 64-bit exponent e >= 1: MSB-first
// square-and-multiply, a rolled loop over the bits.
template <int T>
__device__ __forceinline__ void gl_pow64(uint64_t (&x)[T], uint64_t e) {
  uint64_t base[T];
#pragma unroll
  for (int i = 0; i < T; ++i) base[i] = x[i];
#pragma unroll 1
  for (int bit = 62 - __clzll(static_cast<long long>(e)); bit >= 0; --bit) {
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = gl_sqr(x[i]);
    if ((e >> bit) & 1u) {
#pragma unroll
      for (int i = 0; i < T; ++i) x[i] = gl_mul(x[i], base[i]);
    }
  }
}

// lo + hi 2^32 mod p as a word below 2^64, for accumulators whose sum
// lies below 2^96: the sum's 2^64s, k = hi / 2^32 plus the low add's
// carry, come back as k (2^32 - 1) by gl_add (k (2^32 - 1) < p while
// k < 2^32: ops/bounds.py _RescueGLSim.narrow).
__device__ __forceinline__ uint64_t gl_narrow(uint64_t lo, uint64_t hi) {
  const uint64_t s = lo + (hi << 32);
  const uint64_t k = (hi >> 32) + (s < lo ? 1ull : 0ull);
  return gl_add(s, (k << 32) - k);
}

// x <- MDS x + rc: narrow rows (entries below 2^32 whose sums the replay
// keeps below 2^64) or gl_row's, then the constants by gl_add.
template <int T>
__device__ __forceinline__ void gl_affine(uint64_t (&x)[T], const volatile uint64_t* mds, const uint64_t* rc,
                                          bool narrow) {
  uint64_t y[T];
  if (narrow) {
    const volatile uint32_t* m = reinterpret_cast<const volatile uint32_t*>(mds);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint64_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t c = m[2 * (i * T + j)];
        lo += static_cast<uint64_t>(static_cast<uint32_t>(x[j])) * c;
        hi += static_cast<uint64_t>(static_cast<uint32_t>(x[j] >> 32)) * c;
      }
      y[i] = gl_narrow(lo, hi);
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) y[i] = gl_row<T>(x, mds + i * T);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = gl_add(y[i], rc[i]);
}

// The two-word body's instantiation of kernel 5 (rescue.cu's limb body is
// rescue_kernel<T, L, MdsFirst>).  Its launch bound asks for one block per
// SM, which lets ptxas give it the registers it wants: 146 at t = 12, 3
// blocks of 128 threads per SM; held to 128 registers (4 blocks) it ran
// 1.16-1.20x slower (PERF.md section 6).
template <int T, bool MdsFirst>
__global__ void __launch_bounds__(kThreads, 1)
    rescue_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B, int rounds, int chain,
                  int narrow, const int32_t* __restrict__ words, int n_words) {
  extern __shared__ int32_t c[];
  stage_constants(c, words, n_words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(c);
  const uint64_t* rc = w + kRescueGlHead;
  const volatile uint64_t* mds = rc + 2 * rounds * T;

  uint64_t x[T];
#pragma unroll
  for (int e = 0; e < T; ++e) x[e] = gl_mul(gl_from_limbs(in + 3 * e * B + b, B), w[0]);
#pragma unroll 1
  for (int h = 0; h < 2 * rounds; ++h) {
    if constexpr (MdsFirst) gl_affine<T>(x, mds, rc + h * T, narrow);
    if (!chain)
      gl_pow64<T>(x, w[2 + (h & 1)]);
    else if (h & 1)
      gl_pow_inv7_groups<0>(x);
    else
      gl_pow7<T>(x);
    if constexpr (!MdsFirst) gl_affine<T>(x, mds, rc + h * T, narrow);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) gl_to_limbs(out + 3 * e * B + b, B, x[e], w[1]);
}

template <int T, bool MdsFirst>
int launch_rescue_gl(const int32_t* in, int32_t* out, long long B, int rounds, int chain, int narrow,
                     const int32_t* words, int n_words, cudaStream_t stream) {
  // 2^-72, 2^72, alpha, 1/alpha | rc | mds, two int32 a value
  if (n_words != 2 * (kRescueGlHead + 2 * rounds * T + T * T)) return -1;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(n_words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(rescue_kernel<T, MdsFirst>, bytes)) return err;
  rescue_kernel<T, MdsFirst><<<blocks, kThreads, bytes, stream>>>(in, out, B, rounds, chain, narrow, words, n_words);
  return static_cast<int>(cudaGetLastError());
}

// The GL(t) lines must match ops/rescue.py BODIES["two-word"], the
// GL_MDS_FIRST(t) lines its MDS_FIRST_PAIRS.
int launch_rescue_words(const int32_t* in, int32_t* out, long long B, int t, int L, int rounds, int mds_first,
                        int chain, int narrow, const int32_t* words, int n_words, cudaStream_t stream) {
  if (L != 3) return -1;
#define GL(T_)           \
  if (t == T_ && !mds_first) \
    return launch_rescue_gl<T_, false>(in, out, B, rounds, chain, narrow, words, n_words, stream);
#define GL_MDS_FIRST(T_) \
  if (t == T_ && mds_first)  \
    return launch_rescue_gl<T_, true>(in, out, B, rounds, chain, narrow, words, n_words, stream);
  GL(5)
  GL(6)
  GL(7)
  GL(8)
  GL(9)
  GL(10)
  GL(11)
  GL(12)
  GL_MDS_FIRST(12)
#undef GL
#undef GL_MDS_FIRST
  return -1;
}

}  // namespace sponge
