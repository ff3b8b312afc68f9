// Kernel 2's word bodies: the dense Poseidon permutation (see
// poseidon_dense.cu) over fields that fit one or two 32-bit words.  The limb
// body spends two 24-bit limbs on a 31-bit element (8 widening products a
// Montgomery product, a carry pass and masks) and three on a Goldilocks one
// (18), where one word or two need 2 and 4.  Each body keeps the state in
// registers, stages its word constants (ops/poseidon_dense.py
// word_constants) in shared memory, raises a full round's t elements in
// lockstep and reads the MDS through a volatile pointer, so ptxas cannot
// hoist the t^2 round-invariant entries into registers across the round
// loop (kernel 3's one-word body found it at 255 registers and spills).
//
// The one-word body (poseidon_dense_word_kernel; BabyBear, KoalaBear and
// Mersenne31 at t = 16): an element is one canonical word in Montgomery
// form with R' = 2^32 (words.cuh word_mul, word_sub, word_sbox), converted
// from the plane's R = 2^48 by one product by 2^16 mod p on entry and back
// by one by 2^48 mod p on exit, as kernel 3's one-word body.  Poseidon's MDS
// is a Cauchy matrix of full-field constants, so a row is t products of
// two canonical words, each below p^2 < 2^62: a 64-bit sum holds only four
// of them (Mersenne31: 4 p^2 = 2^64 - 2^34 + 4).  word_row sums the row in
// groups of kWordGroup = 4 products, one 64-bit multiply-add each, and
// splits each group sum g at 2^32 into hi (g >> 32) and lo (g mod 2^32)
// sums; the row is then (hi 2^32 + lo) / R' = hi + lo / R' mod p: one REDC
// of the lo sum (below 2^34, so lo + q p stays below 2^64 and the REDC below
// p + 4), added to hi (below 2^34) and reduced once by reduce_wide (below
// 2^40 -> below 2p) and word_sub.  A row costs t + 2 widening products and
// 2 narrow ones, against t word_mul's 2 t and t, and no carry word.
//
// The two-word body (poseidon_dense_gl_kernel; Goldilocks at t = 8 and 12):
// an element is a 64-bit word in plain form, not necessarily below p
// (words.cuh gl_mul, gl_sqr, gl_sbox), converted from the plane's R = 2^72
// by one product by 2^-72 mod p on entry and back by one by 2^72 mod p and
// a conditional subtraction on exit, as kernel 8's two-word body.  ARK is a
// 64-bit add whose carry out of 2^64 comes back as 2^32 - 1 (gl_add).  An
// MDS row is t 128-bit products summed in a five-word accumulator by PTX
// carry chains (gl_mac: t 2^128 needs 132 bits at t = 12), then reduced once
// with 2^64 = 2^32 - 1, 2^96 = -1 and 2^128 = -2^32 mod p (gl_reduce5).
//
// The replays ops/bounds.py _DenseWordSim and _DenseGLSim prove every word,
// sum and reduction of these schedules in range; they run before every
// launch.
//
// Word constant layouts (int32; ops/poseidon_dense.py word_constants):
// one-word: p, -p^-1 mod 2^32, 2^16 mod p, 2^48 mod p, floor(2^48 / p) |
// ark (R, t) | mds (t, t), the constants as canonical words at R';
// two-word: 2^-72 mod p, 2^72 mod p | ark (R, t) | mds (t, t), each a
// 64-bit plain value in two 32-bit words, low first.

#include "mont.cuh"
#include "words.cuh"

namespace sponge {

// ---- the one-word body ----

constexpr int kWordHead = 5;
constexpr int kWordGroup = 4;  // products per 64-bit group sum (ops/bounds.py DENSE_WORD_GROUP)

// (sum_j x_j m_j) / R' mod p, canonical, for canonical words x_j and the
// row's canonical constants m_j.
template <int T>
__device__ __forceinline__ uint32_t word_row(const uint32_t (&x)[T], const volatile int32_t* m,
                                             const WordField& f) {
  uint64_t hi = 0, lo = 0;
#pragma unroll
  for (int g = 0; g < T; g += kWordGroup) {
    uint64_t s = 0;
#pragma unroll
    for (int j = g; j < g + kWordGroup && j < T; ++j)
      s += static_cast<uint64_t>(x[j]) * static_cast<uint32_t>(m[j]);
    hi += s >> 32;
    lo += static_cast<uint32_t>(s);
  }
  const uint32_t q = static_cast<uint32_t>(lo) * f.n0;
  const uint64_t r = (lo + static_cast<uint64_t>(q) * f.p) >> 32;
  return word_sub(reduce_wide(hi + r, f), f);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    poseidon_dense_word_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                               uint32_t alpha, int full_rounds, int partial_rounds,
                               const int32_t* __restrict__ consts, int words) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const WordField f{static_cast<uint32_t>(c[0]), static_cast<uint32_t>(c[1]), static_cast<uint32_t>(c[4])};
  const uint32_t to_word = static_cast<uint32_t>(c[2]), from_word = static_cast<uint32_t>(c[3]);
  const int32_t* ark = c + kWordHead;
  const volatile int32_t* mds = ark + (full_rounds + partial_rounds) * T;
  const int half = full_rounds / 2;

  uint32_t x[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint32_t lo = static_cast<uint32_t>(in[(2 * e) * B + b]);
    const uint32_t hi = static_cast<uint32_t>(in[(2 * e + 1) * B + b]);
    x[e] = word_sub(word_mul(lo | (hi << kLimbBits), to_word, f), f);  // x R -> x R'
  }
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) x[e] = word_sub(x[e] + static_cast<uint32_t>(FromShared::load(ark + r * T + e)), f);
    if (r >= half && r < half + partial_rounds)
      word_sbox<1>(reinterpret_cast<uint32_t(&)[1]>(x[0]), alpha, f);
    else
      word_sbox<T>(x, alpha, f);
    uint32_t y[T];
#pragma unroll
    for (int i = 0; i < T; ++i) y[i] = word_row<T>(x, mds + i * T, f);
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = y[i];
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint32_t v = word_sub(word_mul(x[e], from_word, f), f);  // x R' -> x R, canonical
    out[(2 * e) * B + b] = static_cast<int32_t>(v & kLimbMask);
    out[(2 * e + 1) * B + b] = static_cast<int32_t>(v >> kLimbBits);
  }
}

// ---- the two-word body (Goldilocks) ----

constexpr int kGlHead = 2;  // 64-bit words

// x + c mod p for a word x below 2^64 and c below p: the carry out of 2^64
// comes back as 2^32 - 1, which cannot wrap again (x + c - 2^64 is below
// 2^64 - 2^32).
__device__ __forceinline__ uint64_t gl_add(uint64_t x, uint64_t c) {
  const uint64_t s = x + c;
  return s + (s < c ? 0xFFFFFFFFull : 0ull);
}

// n4..n0 (32-bit words) += a b, the 128-bit product from the four 32-bit
// halves' products in multiply-add carry chains, the carries out of 2^128
// into n4.
__device__ __forceinline__ void gl_mac(uint32_t (&n)[5], uint64_t a, uint64_t b) {
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %5;\n\t"
      "mov.b64 {b0, b1}, %6;\n\t"
      "mad.lo.cc.u32 %0, a0, b0, %0;\n\t"
      "madc.hi.cc.u32 %1, a0, b0, %1;\n\t"
      "madc.lo.cc.u32 %2, a1, b1, %2;\n\t"
      "madc.hi.cc.u32 %3, a1, b1, %3;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
      "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
      "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "}"
      : "+r"(n[0]), "+r"(n[1]), "+r"(n[2]), "+r"(n[3]), "+r"(n[4])
      : "l"(a), "l"(b));
}

// The 160-bit value n4..n0 mod p as a word below 2^64: GL_REDUCE_N's
// V = n1:n0 - n3 - n2 + n2 2^32 less n4 2^32 (2^128 = -2^32), summed into
// 96 bits (s, n1, n0), s as a signed word -1, 0 or 1 (V lies in
// (-2^64, 2^65) while n4 < 2^32 - 2), then s 2^64 = s (2^32 - 1) added back
// as k1:k0, which cannot wrap again (ops/bounds.py _DenseGLSim.reduce).
__device__ __forceinline__ uint64_t gl_reduce5(const uint32_t (&n)[5]) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 n0, n1, n2, n3, n4, s, k0, k1;\n\t"
      "mov.b32 n0, %1;\n\t"
      "mov.b32 n1, %2;\n\t"
      "mov.b32 n2, %3;\n\t"
      "mov.b32 n3, %4;\n\t"
      "mov.b32 n4, %5;\n\t"
      "sub.cc.u32 n0, n0, n3;\n\t"
      "subc.cc.u32 n1, n1, 0;\n\t"
      "subc.u32 s, 0, 0;\n\t"
      "sub.cc.u32 n0, n0, n2;\n\t"
      "subc.cc.u32 n1, n1, 0;\n\t"
      "subc.u32 s, s, 0;\n\t"
      "add.cc.u32 n1, n1, n2;\n\t"
      "addc.u32 s, s, 0;\n\t"
      "sub.cc.u32 n1, n1, n4;\n\t"
      "subc.u32 s, s, 0;\n\t"
      "neg.s32 k0, s;\n\t"
      "shr.s32 k1, s, 31;\n\t"
      "add.cc.u32 n0, n0, k0;\n\t"
      "addc.u32 n1, n1, k1;\n\t"
      "mov.b64 %0, {n0, n1};\n\t"
      "}"
      : "=l"(r)
      : "r"(n[0]), "r"(n[1]), "r"(n[2]), "r"(n[3]), "r"(n[4]));
  return r;
}

// sum_j x_j m_j mod p as a word below 2^64.
template <int T>
__device__ __forceinline__ uint64_t gl_row(const uint64_t (&x)[T], const volatile uint64_t* m) {
  uint32_t n[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < T; ++j) gl_mac(n, x[j], m[j]);
  return gl_reduce5(n);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    poseidon_dense_gl_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                             uint32_t alpha, int full_rounds, int partial_rounds,
                             const int32_t* __restrict__ consts, int words) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(c);
  const uint64_t to_word = w[0], from_word = w[1];  // 2^-72 and 2^72 mod p
  const uint64_t* ark = w + kGlHead;
  const volatile uint64_t* mds = ark + (full_rounds + partial_rounds) * T;
  const int half = full_rounds / 2;

  uint64_t x[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint64_t v = static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e) * B + b])) |
                       static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e + 1) * B + b])) << kLimbBits |
                       static_cast<uint64_t>(static_cast<uint32_t>(in[(3 * e + 2) * B + b])) << (2 * kLimbBits);
    x[e] = gl_mul(v, to_word);  // x R -> x
  }
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) x[e] = gl_add(x[e], ark[r * T + e]);
    if (r >= half && r < half + partial_rounds)
      x[0] = gl_pow(x[0], alpha);
    else
      gl_sbox<T>(x, alpha);
    uint64_t y[T];
#pragma unroll
    for (int i = 0; i < T; ++i) y[i] = gl_row<T>(x, mds + i * T);
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = y[i];
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    uint64_t v = gl_mul(x[e], from_word);  // x -> x R
    if (v >= kGoldilocksP) v -= kGoldilocksP;
    out[(3 * e) * B + b] = static_cast<int32_t>(v & kLimbMask);
    out[(3 * e + 1) * B + b] = static_cast<int32_t>((v >> kLimbBits) & kLimbMask);
    out[(3 * e + 2) * B + b] = static_cast<int32_t>(v >> (2 * kLimbBits));
  }
}

template <typename Kernel>
int launch_word_body(Kernel* kernel, const int32_t* in, int32_t* out, long long B, int alpha,
                     int full_rounds, int partial_rounds, const int32_t* words, int n_words,
                     cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(n_words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(kernel, bytes)) return err;
  kernel<<<blocks, kThreads, bytes, stream>>>(in, out, B, static_cast<uint32_t>(alpha), full_rounds,
                                             partial_rounds, words, n_words);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2's word bodies by body code (1: one word, L = 2; 2: two words,
// L = 3) and t; -1 for any other.  The WORD(t) and GL(t) lines must match
// ops/poseidon_dense.py BODIES.
int launch_dense_words(int body, const int32_t* in, int32_t* out, long long B, int t, int L, int alpha,
                       int full_rounds, int partial_rounds, const int32_t* words, int n_words,
                       cudaStream_t stream) {
#define LAUNCH(K) \
  return launch_word_body(K, in, out, B, alpha, full_rounds, partial_rounds, words, n_words, stream);
  if (body == 1 && L == 2) {
#define WORD(T_) \
  if (t == T_) LAUNCH(poseidon_dense_word_kernel<T_>)
    WORD(16)
#undef WORD
  }
  if (body == 2 && L == 3) {
#define GL(T_) \
  if (t == T_) LAUNCH(poseidon_dense_gl_kernel<T_>)
    GL(8)
    GL(12)
#undef GL
  }
#undef LAUNCH
  return -1;
}

}  // namespace sponge
