// Field arithmetic on one or two 32-bit words per element, shared by the
// port's word bodies: kernel 3's one-word body (poseidon2.cu), kernel 8's
// two-word body (gmimc.cu) and kernel 2's two (poseidon_dense_words.cu).
//
// One word (fields below 2^31): an element is one 32-bit word in Montgomery
// form with R' = 2^32 (WordField, word_mul, word_sub, reduce_wide,
// word_sbox).  Two words (Goldilocks, p = 2^64 - 2^32 + 1): an element is a
// 64-bit word in plain form, not necessarily below p; a product's 128 bits
// reduce with 2^64 = 2^32 - 1 and 2^96 = -1 mod p by shifts and adds
// (GL_REDUCE_N, gl_mul, gl_sqr, gl_pow, gl_sbox).  The replays in
// ops/bounds.py (_P2WordSim, _GmimcWordSim, _DenseWordSim, _DenseGLSim)
// prove each kernel's words in range.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

}  // namespace sponge
