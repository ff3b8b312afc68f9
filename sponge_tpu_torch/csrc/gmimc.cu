// Kernel 8: the GMiMC-erf permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_gmimc.py (gmimc_permute_fn, body
// _gmimc_kernel).  Round r:
//     F = (x_0 + c_r)^alpha;  x_i += F for i = 1..t-1;  rotate left by one
// (the original x_0, without the constant, moves to the back).  Only the
// front element ever feeds a multiplier.  Two bodies; the host picks one by
// the field (ops/gmimc.py body).
//
// The limb body (gmimc_kernel), for every field but Goldilocks (the 255-bit
// ones, the test fields): 24-bit limbs, Montgomery R = 2^(24 L).  The kernel
// copies the front, adds c_r with a carry (add_const) and raises the copy to
// alpha (pow_sqr1, squaring by mont_sqr); F is added to the other t-1
// elements word by word with no carry and no reduction, and those adds stay
// deferred for the whole permutation: an element's limb words grow by up to
// 2^24 per add (about 2^31.3 at t = 3, 226 rounds) and its value by F.
// ops/bounds.py check_gmimc_bounds replays this schedule on exclusive value
// and word bounds and refuses a config whose words could reach 2^32 or whose
// front could reach R.  The elements grow to hundreds of p, and so does the
// S-box input f (the front plus c_r); a Montgomery product of such an input
// leaves its output far above p, and that F feeds every later element.  At
// BLS12-381 (R = 565p) that passes R from t = 4 on, so where the replay
// without it fails the kernel takes the front reduction (reduce_front; the
// runtime flag ``reduce`` picks the instantiation with it, so a config
// without it launches the body unchanged): f - q p with q = floor(top *
// qinv / 2^32), top f's top word and qinv = floor((2^32 - 1) / (p_top + 1)),
// p_top p's top limb, so q p <= f; f leaves below about 2p for L 64-bit
// multiply-adds and one 32-bit product, against the round's three
// Montgomery products, and F stays near p.  Exit: one carry pass and one
// Montgomery product by 1
// (values below 2p) and a conditional subtraction, so the output is
// canonical.  Each block first copies its constants (p, R mod p, the round
// constants: about 10 KB at BLS12-381) to shared memory and reads every
// constant there, the modulus included: from global memory at a warp-uniform
// address ptxas keeps the modulus in uniform registers and splits each REDC
// product's 64-bit accumulate into an IADD3 pair (kernel 1, PERF.md).
//
// The two-word body (gmimc_word_kernel), for Goldilocks p = 2^64 - 2^32 + 1,
// where three 24-bit limbs spend 18 widening products and carry passes on a
// value two 32-bit words hold exactly.  An element is a 64-bit word
// congruent to it mod p (below 2^64, not always below p), in plain form, not
// Montgomery: a product is the 128-bit a b from the four 32-bit halves'
// products (three for a squaring), reduced with no multiply, as
// 2^64 = 2^32 - 1 and 2^96 = -1 mod p (GL_REDUCE_N).  Products, reductions
// and folds are written as PTX carry chains: written in C, the same
// arithmetic compiled to 64-bit compares, selects and zeroed high words
// and took about 1.4x the time (PERF.md).  The rest-branch adds defer
// their carries: each element keeps a third word, its excess, counting the
// 2^64s its adds carried out, so x + F is one 64-bit add and the carry's add
// to the excess (three instructions, gl_add_deferred), where a reduced add
// takes six and a canonical F; the front folds its excess in when it feeds
// the power (gl_fold: x + c_r + excess (2^32 - 1), one fix-up).  The plane's
// R = 2^72 is converted once at entry (a product by 2^-72 mod p) and once at
// exit (by 2^72 mod p, then a conditional subtraction: canonical limbs).
// ops/bounds.py check_gmimc_word_bounds replays this schedule and proves
// every word, carry, excess and 128-bit partial sum below its limit.
//
// The rotation is a register rename in both bodies: the round loop is
// unrolled t times, so round r + j of a block takes its front from register
// x[j] and no state moves; after the loop the state sits rotated by
// rounds mod t and is turned back with at most t - 1 register moves of the
// whole state.  The limb body's wide states (mont.cuh kWideState: t = 4..9
// at L = 11) instead run one rolled round loop that rotates as it adds,
// x[e - 1] = x[e] + F and x[t - 1] = the old front (L moves a round), so
// the S-box chain is inlined once: unrolled t times at L = 11, nvcc 12.9's
// cicc crashed (exit 139) on this file.
//
// What bounds it on the H100: integer issue (the limb body's widening
// products; the two-word body's adds and carry fix-ups as much as its
// products) and the latency of one serial chain per lane: alpha = 5 is three
// dependent Montgomery products per round at BLS12-381 (226 rounds),
// alpha = 7 four two-word products at Goldilocks (62 rounds), with only
// occupancy to hide them.  Design: one thread per lane, state in registers,
// constants staged in shared memory, one rolled loop over blocks of t rounds.
//
// Constant buffer layout (int32, limb axis last; gmimc/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (rounds, L), and at
// Goldilocks the two-word body's section: 2^-72 mod p (2) | 2^72 mod p (2) |
// rc (rounds, 2), each 64-bit word low half first.

#include "mont.cuh"
#include "words.cuh"

namespace sponge {

template <int T, typename V>
__device__ __forceinline__ void rotate_words_left(V (&x)[T]) {
  const V first = x[0];
#pragma unroll
  for (int e = 0; e < T - 1; ++e) x[e] = x[e + 1];
  x[T - 1] = first;
}

template <int T, int L>
__device__ __forceinline__ void rotate_left(uint32_t (&x)[T][L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint32_t first = x[0][k];
#pragma unroll
    for (int e = 0; e < T - 1; ++e) x[e][k] = x[e + 1][k];
    x[T - 1][k] = first;
  }
}

// f - q p for a carried f (limbs 0..L-2 below 2^24, the rest of its value
// in the top word) with q = floor(top * qinv / 2^32) <= top / (p_top + 1),
// so q p <= f and the result is a non-negative carried value: limb by limb in
// signed 64-bit words (q p_k < 2^56), each borrow a floor shift.
// ops/bounds.py _Replay.reduce_front bounds its output.
template <int L>
__device__ __forceinline__ void reduce_front(uint32_t (&f)[L], const Modulus<L>& m, uint32_t qinv) {
  const uint64_t q = __umulhi(f[L - 1], qinv);
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < L - 1; ++k) {
    const int64_t v = static_cast<int64_t>(f[k]) + c - static_cast<int64_t>(q * m.p[k]);
    f[k] = static_cast<uint32_t>(v) & kLimbMask;
    c = v >> kLimbBits;
  }
  f[L - 1] = static_cast<uint32_t>(static_cast<int64_t>(f[L - 1]) + c - static_cast<int64_t>(q * m.p[L - 1]));
}

template <int T, int L, bool Reduce>
__global__ void __launch_bounds__(kThreads)
    gmimc_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                 int rounds, uint32_t alpha, const int32_t* __restrict__ consts, int words,
                 uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;  // from the staged copy, so it lands in ordinary registers
  load_modulus<FromShared>(m, c, n0inv);
  const int32_t* one = c + L;
  const int32_t* rc = one + L;
  const uint32_t qinv = Reduce ? 0xFFFFFFFFu / (m.p[L - 1] + 1u) : 0u;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  if constexpr (kWideState<T, L>) {
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      uint32_t f[L], front[L];
#pragma unroll
      for (int k = 0; k < L; ++k) f[k] = front[k] = x[0][k];
      add_const<FromShared>(f, rc + r * L);
      if constexpr (Reduce) reduce_front(f, m, qinv);
      pow_sqr1<L>(f, alpha, m);
#pragma unroll
      for (int e = 1; e < T; ++e)
#pragma unroll
        for (int k = 0; k < L; ++k) x[e - 1][k] = x[e][k] + f[k];  // deferred: no carry
#pragma unroll
      for (int k = 0; k < L; ++k) x[T - 1][k] = front[k];
    }
  } else {
#pragma unroll 1
    for (int r0 = 0; r0 < rounds; r0 += T) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (r0 + j < rounds) {
          uint32_t f[L];
#pragma unroll
          for (int k = 0; k < L; ++k) f[k] = x[j][k];
          add_const<FromShared>(f, rc + (r0 + j) * L);
          if constexpr (Reduce) reduce_front(f, m, qinv);
          pow_sqr1<L>(f, alpha, m);
#pragma unroll
          for (int e = 0; e < T; ++e) {
            if (e == j) continue;
#pragma unroll
            for (int k = 0; k < L; ++k) x[e][k] += f[k];  // deferred: no carry
          }
        }
      }
    }
#pragma unroll 1
    for (int s = 0; s < rounds % T; ++s) rotate_left<T, L>(x);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    carry_pass(x[e]);
    mont_mul_staged(x[e], x[e], one, m);
  }
  store_state<T, L>(out, x, B, b, m);
}

// ---- the two-word body (Goldilocks; its word arithmetic: words.cuh) ----

// x + f, its carry out of 2^64 added to the excess word e: three
// instructions, no reduction.
__device__ __forceinline__ void gl_add_deferred(uint64_t& x, uint32_t& e, uint64_t f) {
  asm("{\n\t"
      ".reg .u32 x0, x1, f0, f1;\n\t"
      "mov.b64 {x0, x1}, %0;\n\t"
      "mov.b64 {f0, f1}, %2;\n\t"
      "add.cc.u32 x0, x0, f0;\n\t"
      "addc.cc.u32 x1, x1, f1;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "mov.b64 %0, {x0, x1};\n\t"
      "}"
      : "+l"(x), "+r"(e)
      : "l"(f));
}

// x + e 2^64 + c (c < p) -> a word below 2^64 congruent to it mod p: with
// k = e + the carry of x + c, the sum s plus k (2^32 - 1) = s - k + k 2^32
// in 96 bits (t, s), t 0 or 1, then t 2^64 = t (2^32 - 1) added back, which
// cannot wrap again (ops/bounds.py _GmimcWordSim.fold).
__device__ __forceinline__ uint64_t gl_fold(uint64_t x, uint32_t e, uint64_t c) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 x0, x1, c0, c1, k, t, m;\n\t"
      "mov.b64 {x0, x1}, %1;\n\t"
      "mov.b64 {c0, c1}, %3;\n\t"
      "add.cc.u32 x0, x0, c0;\n\t"
      "addc.cc.u32 x1, x1, c1;\n\t"
      "addc.u32 k, %2, 0;\n\t"
      "sub.cc.u32 x0, x0, k;\n\t"
      "subc.cc.u32 x1, x1, 0;\n\t"
      "subc.u32 t, 0, 0;\n\t"
      "add.cc.u32 x1, x1, k;\n\t"
      "addc.u32 t, t, 0;\n\t"
      "neg.s32 m, t;\n\t"
      "add.cc.u32 x0, x0, m;\n\t"
      "addc.u32 x1, x1, 0;\n\t"
      "mov.b64 %0, {x0, x1};\n\t"
      "}"
      : "=l"(r)
      : "l"(x), "r"(e), "l"(c));
  return r;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    gmimc_word_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                      int rounds, uint32_t alpha, const int32_t* __restrict__ consts, int words) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(c);
  const uint64_t to_word = w[0], from_word = w[1];  // 2^-72 and 2^72 mod p
  const uint64_t* rc = w + 2;

  uint64_t x[T];
  uint32_t ex[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint64_t v = static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e) * B + b])) |
                       static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e + 1) * B + b])) << kLimbBits |
                       static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e + 2) * B + b])) << (2 * kLimbBits);
    x[e] = gl_mul(v, to_word);  // x R -> x
    ex[e] = 0;
  }
#pragma unroll 1
  for (int r0 = 0; r0 < rounds; r0 += T) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (r0 + j < rounds) {
        const uint64_t f = gl_pow(gl_fold(x[j], ex[j], rc[r0 + j]), alpha);
#pragma unroll
        for (int e = 0; e < T; ++e)
          if (e != j) gl_add_deferred(x[e], ex[e], f);
      }
    }
  }
#pragma unroll 1
  for (int s = 0; s < rounds % T; ++s) {
    rotate_words_left<T>(x);
    rotate_words_left<T>(ex);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    uint64_t v = gl_mul(gl_fold(x[e], ex[e], 0), from_word);  // x -> x R
    if (v >= kGoldilocksP) v -= kGoldilocksP;
    out[(3 * e) * B + b] = static_cast<int32_t>(v & kLimbMask);
    out[(3 * e + 1) * B + b] = static_cast<int32_t>((v >> kLimbBits) & kLimbMask);
    out[(3 * e + 2) * B + b] = static_cast<int32_t>(v >> (2 * kLimbBits));
  }
}

template <int T, int L, bool Reduce>
int launch_gmimc_body(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha,
                      const int32_t* consts, int words, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(gmimc_kernel<T, L, Reduce>, bytes)) return err;
  gmimc_kernel<T, L, Reduce><<<blocks, kThreads, bytes, stream>>>(in, out, B, rounds, alpha, consts,
                                                                  words, n0inv);
  return static_cast<int>(cudaGetLastError());
}

template <int T, int L>
int launch_gmimc(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha,
                 int reduce, const int32_t* consts, int words, unsigned n0inv, cudaStream_t stream) {
  return reduce ? launch_gmimc_body<T, L, true>(in, out, B, rounds, alpha, consts, words, n0inv, stream)
                : launch_gmimc_body<T, L, false>(in, out, B, rounds, alpha, consts, words, n0inv, stream);
}

template <int T>
int launch_gmimc_word(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha,
                      const int32_t* consts, int words, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(gmimc_word_kernel<T>, bytes)) return err;
  gmimc_word_kernel<T><<<blocks, kThreads, bytes, stream>>>(in, out, B, rounds, alpha, consts, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when the body has
// no instantiation at (t, L).  ``body`` is 0 for the limb body (``consts`` the
// whole buffer, ``words`` its limb sections; ``reduce`` takes the front
// reduction) and 1 for the two-word body (``consts`` its section, ``words``
// that section's length; ``reduce`` unused).  Instantiations (the limb
// body's PAIR(t, L) lines, the two-word body's WORD(t) lines at L = 3) must
// match ops/gmimc.py BODIES and INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_gmimc(const int32_t* in, int32_t* out, long long B, int t, int L, int body,
                            int rounds, unsigned alpha, int reduce, const int32_t* consts, int words,
                            unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) {
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_gmimc<T_, L_>(in, out, B, rounds, alpha, reduce, consts, words, n0inv, s);
    PAIR(2, 11)
    PAIR(3, 11)
    PAIR(4, 11)
    PAIR(5, 11)
    PAIR(6, 11)
    PAIR(7, 11)
    PAIR(8, 11)
    PAIR(9, 11)
    PAIR(8, 3)
    PAIR(3, 2)
#undef PAIR
    return -1;
  }
  if (body != 1 || L != 3) return -1;
#define WORD(T_) \
  if (t == T_) return sponge::launch_gmimc_word<T_>(in, out, B, rounds, alpha, consts, words, s);
  WORD(5)
  WORD(6)
  WORD(7)
  WORD(8)
  WORD(9)
  WORD(10)
  WORD(11)
  WORD(12)
#undef WORD
  return -1;
}
