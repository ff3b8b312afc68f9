// Field arithmetic on one or two 32-bit words per element, shared by the
// port's word bodies: kernel 3's one-word body (poseidon2.cu), kernel 8's
// two-word body (gmimc.cu), kernel 2's two (poseidon_dense_words.cu),
// kernel 1's two-word body (poseidon_opt_words.cu) and kernel 5's
// (rescue_words.cu).
//
// One word (fields below 2^31): an element is one 32-bit word in Montgomery
// form with R' = 2^32 (WordField, word_mul, word_sub, reduce_wide,
// word_sbox).  Two words (Goldilocks, p = 2^64 - 2^32 + 1): an element is a
// 64-bit word in plain form, not necessarily below p; a product's 128 bits
// reduce with 2^64 = 2^32 - 1 and 2^96 = -1 mod p by shifts and adds
// (GL_REDUCE_N, gl_mul, gl_sqr, gl_pow, gl_sbox); a sum of such products
// is held in five 32-bit words and reduced once (gl_mac, gl_reduce5,
// gl_row).  The two-word bodies read and write the port's planes of
// canonical 24-bit Montgomery limbs (gl_from_limbs, gl_to_limbs).  The
// replays in ops/bounds.py (_P2WordSim, _GmimcWordSim, _DenseWordSim,
// _DenseGLSim, _OptGLSim, _RescueGLSim) prove each kernel's words in range.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

namespace sponge {

struct WordField {
  uint32_t p, n0, barrett;  // p, -p^-1 mod 2^32, floor(2^48 / p)
};

// (a b + q p) / 2^32 = a b / R' (mod p), below a b / 2^32 + p; the replay
// keeps a b + q p below 2^64.
__device__ __forceinline__ uint32_t word_mul(uint32_t a, uint32_t b, const WordField& f) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t q = static_cast<uint32_t>(t) * f.n0;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(q) * f.p) >> 32);
}

// v < 2p -> v mod p.
__device__ __forceinline__ uint32_t word_sub(uint32_t v, const WordField& f) {
  return min(v, v - f.p);
}

// A 64-bit sum s < 2^40 -> s mod p up to one p (below 2p): the quotient
// floor(floor(s / 2^8) * floor(2^48 / p) / 2^40) is floor(s / p) or one less.
__device__ __forceinline__ uint32_t reduce_wide(uint64_t s, const WordField& f) {
  const uint32_t q =
      static_cast<uint32_t>((static_cast<uint64_t>(static_cast<uint32_t>(s >> 8)) * f.barrett) >> 40);
  return static_cast<uint32_t>(s) - q * f.p;
}

// x^alpha on N canonical words in lockstep (square-and-multiply over the
// bits of alpha, a rolled loop); every product ends below p.
template <int N>
__device__ __forceinline__ void word_sbox(uint32_t (&x)[N], uint32_t alpha, const WordField& f) {
  uint32_t base[N];
#pragma unroll
  for (int e = 0; e < N; ++e) base[e] = x[e];
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = word_sub(word_mul(x[e], x[e], f), f);
    if ((alpha >> bit) & 1u) {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = word_sub(word_mul(x[e], base[e], f), f);
    }
  }
}

constexpr uint64_t kGoldilocksP = 0xFFFFFFFF00000001ull;

// The reduction of a 128-bit value n3 n2 n1 n0 (32-bit words) held in the
// PTX registers n0..n3, into n1:n0: with 2^64 = 2^32 - 1 and 2^96 = -1 mod p
// it is V = n1:n0 - n3 - n2 + n2 2^32, summed into 96 bits (s, n1, n0) by
// carry chains, where s, as a signed word, is -1, 0 or 1 (V lies in
// (-2^32, 2^65)); then s 2^64 = s (2^32 - 1) is added back as the 64-bit
// k1:k0, which cannot wrap again (ops/bounds.py _GmimcWordSim.reduce).
// Uses the PTX registers s, k0, k1.
#define GL_REDUCE_N          \
  "sub.cc.u32 n0, n0, n3;\n\t" \
  "subc.cc.u32 n1, n1, 0;\n\t" \
  "subc.u32 s, 0, 0;\n\t"      \
  "sub.cc.u32 n0, n0, n2;\n\t" \
  "subc.cc.u32 n1, n1, 0;\n\t" \
  "subc.u32 s, s, 0;\n\t"      \
  "add.cc.u32 n1, n1, n2;\n\t" \
  "addc.u32 s, s, 0;\n\t"      \
  "neg.s32 k0, s;\n\t"         \
  "shr.s32 k1, s, 31;\n\t"     \
  "add.cc.u32 n0, n0, k0;\n\t" \
  "addc.u32 n1, n1, k1;\n\t"

// a b mod p, a word below 2^64: the 128-bit product from the four 32-bit
// halves' products in one multiply-add carry chain, then GL_REDUCE_N.
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, n0, n1, n2, n3, s, k0, k1;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "mul.lo.u32 n0, a0, b0;\n\t"
      "mul.hi.u32 n1, a0, b0;\n\t"
      "mad.lo.cc.u32 n1, a0, b1, n1;\n\t"
      "madc.hi.u32 n2, a0, b1, 0;\n\t"
      "mad.lo.cc.u32 n1, a1, b0, n1;\n\t"
      "madc.hi.cc.u32 n2, a1, b0, n2;\n\t"
      "madc.hi.u32 n3, a1, b1, 0;\n\t"
      "mad.lo.cc.u32 n2, a1, b1, n2;\n\t"
      "addc.u32 n3, n3, 0;\n\t"
      GL_REDUCE_N
      "mov.b64 %0, {n0, n1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// a^2 mod p: the cross product a0 a1 formed once and doubled in 96 bits,
// then GL_REDUCE_N.
__device__ __forceinline__ uint64_t gl_sqr(uint64_t a) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, n0, n1, n2, n3, c0, c1, c2, s, k0, k1;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mul.lo.u32 n0, a0, a0;\n\t"
      "mul.hi.u32 n1, a0, a0;\n\t"
      "mul.lo.u32 c0, a0, a1;\n\t"
      "mul.hi.u32 c1, a0, a1;\n\t"
      "add.cc.u32 c0, c0, c0;\n\t"
      "addc.cc.u32 c1, c1, c1;\n\t"
      "addc.u32 c2, 0, 0;\n\t"
      "add.cc.u32 n1, n1, c0;\n\t"
      "madc.lo.cc.u32 n2, a1, a1, c1;\n\t"
      "madc.hi.u32 n3, a1, a1, c2;\n\t"
      GL_REDUCE_N
      "mov.b64 %0, {n0, n1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a));
  return r;
}

// x^alpha by MSB-first square-and-multiply over the bits of alpha (a rolled
// loop: any config's alpha runs).
__device__ __forceinline__ uint64_t gl_pow(uint64_t x, uint32_t alpha) {
  uint64_t acc = x;
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
    acc = gl_sqr(acc);
    if ((alpha >> bit) & 1u) acc = gl_mul(acc, x);
  }
  return acc;
}

// x^alpha on N words below 2^64 in lockstep (square-and-multiply over the
// bits of alpha, a rolled loop): gl_pow's chain on every element.
template <int N>
__device__ __forceinline__ void gl_sbox(uint64_t (&x)[N], uint32_t alpha) {
  uint64_t base[N];
#pragma unroll
  for (int e = 0; e < N; ++e) base[e] = x[e];
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = gl_sqr(x[e]);
    if ((alpha >> bit) & 1u) {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = gl_mul(x[e], base[e]);
    }
  }
}

// 64-bit words at the head of the Poseidon two-word bodies' constant
// buffers (kernels 1 and 2): 2^-72 mod p and 2^72 mod p, which convert the
// plane's Montgomery form (R = 2^72) to plain form and back.
constexpr int kGlHead = 2;

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

// The canonical value whose three 24-bit limbs lie at src, src + stride and
// src + 2 stride.
__device__ __forceinline__ uint64_t gl_from_limbs(const int32_t* __restrict__ src, long long stride) {
  return static_cast<uint64_t>(static_cast<uint32_t>(src[0])) |
         static_cast<uint64_t>(static_cast<uint32_t>(src[stride])) << kLimbBits |
         static_cast<uint64_t>(static_cast<uint32_t>(src[2 * stride])) << (2 * kLimbBits);
}

// A word x below 2^64 converted x -> x R by one product by from_word =
// 2^72 mod p (below 2^64 < 2p) and one conditional subtraction, stored as
// three canonical 24-bit limbs at dst, dst + stride and dst + 2 stride.
__device__ __forceinline__ void gl_to_limbs(int32_t* __restrict__ dst, long long stride, uint64_t x,
                                            uint64_t from_word) {
  uint64_t v = gl_mul(x, from_word);
  if (v >= kGoldilocksP) v -= kGoldilocksP;
  dst[0] = static_cast<int32_t>(v & kLimbMask);
  dst[stride] = static_cast<int32_t>((v >> kLimbBits) & kLimbMask);
  dst[2 * stride] = static_cast<int32_t>(v >> (2 * kLimbBits));
}

}  // namespace sponge
