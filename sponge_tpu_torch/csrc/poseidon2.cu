// Kernel 3: the Poseidon2 permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_p2.py (p2_permute_fn, body _p2_kernel).
// Schedule (ePrint 2023/323): M_E; R_F/2 external rounds (x += rc, x^alpha
// on every element, M_E); R_P internal rounds (x0 += rc, x0^alpha,
// M_I = J + diag(mu - 1)); R_F/2 external rounds; then the exit.  Two bodies;
// the host picks one per config (ops/bounds.py check_p2_bounds).
//
// The one-word body (poseidon2_word_kernel), for fields below 2^31
// (BabyBear, KoalaBear and Mersenne31 at t = 16, the 25-bit test field):
// the 24-bit limb plan spends two limbs, a carry pass and masks on every
// product, while one element fits one 32-bit word and one mul.wide.u32
// forms its product.  Each element is one word in Montgomery form with
// R' = 2^32: a product is T = a b (64 bits), q = T * (-p^-1) mod 2^32 and
// (T + q p) / 2^32, then one conditional subtraction (min(v, v - p)), so
// every product input is below p.  The plane's two 24-bit limbs (R = 2^48)
// become one word by a product by 2^16 mod p, and the exit's product by
// 2^48 mod p takes the value back to R = 2^48 before the limbs are split.
// M_E sums each row in 64 bits and reduces it once (reduce_wide, a
// multiply-high quotient, result below 2p); where the config's matrix is
// circ(2 M4, M4, ..., M4) with Poseidon2's M4 (found on the host) the rows
// come from M4's addition chain on each chunk of four and the chunks' sums,
// with no multiply, else from the dense small-integer rows.  M_I is the sum
// sigma (reduced the same way) plus one product by the diagonal in R' form
// per element.  Round constants and the diagonal sit in R' form in the
// constant buffer's word section.  The replay ops/bounds.py _P2WordSim
// proves every word below 2^32, every 64-bit product sum below 2^64, every
// row sum inside reduce_wide's range and every subtraction input below 2p.
// Its launch is Plonky3's overwrite sponge (SpongeIO): the rows of up to
// two strided views taken a chunk at a time, each written over the state's
// first rows before a permutation, the state held in registers from a zero
// start to the rows stored.  A row set's padding-free leaf hash is one
// launch of 8-row chunks, a truncated tree node one chunk of t rows from
// the two children where they lie, the plain permutation one chunk of t.
//
// The limb body (poseidon2_kernel), for every other field (the 255-bit ones,
// the 35-bit and 44-bit test fields): 24-bit limbs, Montgomery R = 2^(24 L).
// The linear layers never reduce.  M_E has small non-negative integer
// entries, so a row is the sum of e_ij * x_j over the 24-bit limbs in 32-bit
// words, left deferred.  M_I is the shared limb sum sigma plus (mu_i - 1) x_i:
// a plain integer scale when every mu_i - 1 is below 16 (t = 2, 3), else one
// constant Montgomery product per element.  The next round's constant add is
// a carry pass that puts the whole excess in the top word; values then
// exceed R in the internal phase (sigma sums all elements every round), so a
// top-carry rho-fold brings them back: c = value >> 24L, value += c * (rho -
// R) with rho = R mod p, which keeps the value mod p.  The S-box products
// can also end between R and R + p and are folded.  How many folds each
// round takes before its S-boxes and after each S-box product, and the
// exit, is derived on the host by an exact replay of this schedule on
// integer bounds (ops/bounds.py p2_plan) and passed in a small device
// table; the kernel runs them as unrolled folds behind uniform branches, up
// to kMaxFolds / kMaxSboxFolds, with no fold loop; the same replay checks
// every word below 2^32 and every product input below R.  The S-box
// squares with mont_sqr (pow_sqr's chain).  Exit: a carry pass and its
// folds, one Montgomery product by 1 (below 2p), then a conditional
// subtraction: canonical output.
//
// What bounds it on the H100: integer multiply-add issue (the S-box
// products).  Design: one thread per lane, state in registers for all
// rounds, coalesced (t, L, B) loads and stores, the S-box in lockstep over
// the elements (independent chains for the scheduler; at a wide state,
// mont.cuh kWideState: (4, 11) and (8, 11), one element at a time, which
// keeps one copy of an element live rather than t), one rolled loop over
// all rounds.  Each block first copies its constants to shared memory and
// reads every constant there, the modulus included (kernel 1's finding:
// PERF.md); the products by constants run fully unrolled from there.
//
// Constant buffer layout (int32, limb axis last; poseidon2/config.py
// constant_layout): p (L) | rho (L) | ext rc (R_F, t, L) | int rc (R_P, L) |
// diag_mont (t, L) | mat_e (t, t) | diag_small (t), then for a field below
// 2^31 the word section: p, -p^-1 mod 2^32, 2^16 mod p, 2^48 mod p,
// floor(2^48 / p) | ext rc (R_F, t) | int rc (R_P) | diag (t), in R' form |
// mat_e (t, t).

#include "mont.cuh"
#include "words.cuh"

namespace sponge {

constexpr int kMaxFolds = 2;      // before a round's S-boxes, and at the exit
constexpr int kMaxSboxFolds = 1;  // after each S-box product

// ---- the limb body ----

// x^alpha on N elements in lockstep (pow_sqr's chain), each product followed
// by ``folds`` (0 or 1, warp-uniform) rho-folds.
template <int N, int L>
__device__ __forceinline__ void p2_sbox(uint32_t (&x)[N][L], uint32_t alpha, const Modulus<L>& m,
                                        const int32_t* rho, int folds) {
  uint32_t base[N][L];
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) base[e][k] = x[e][k];
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(alpha)); bit >= 0; --bit) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      mont_sqr(x[e], x[e], m);
      fold_upto<kMaxSboxFolds>(x[e], rho, folds);
    }
    if ((alpha >> bit) & 1u) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        mont_mul(x[e], x[e], base[e], m);
        fold_upto<kMaxSboxFolds>(x[e], rho, folds);
      }
    }
  }
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    poseidon2_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                     int full_rounds, int partial_rounds, uint32_t alpha, int small_diag,
                     const int32_t* __restrict__ consts, int words,
                     const int32_t* __restrict__ plan, uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;  // from the staged copy, so it lands in ordinary registers
  load_modulus<FromShared>(m, c, n0inv);
  const int32_t* rho = c + L;
  const int32_t* ext = rho + L;
  const int32_t* intc = ext + full_rounds * T * L;
  const int32_t* diag_mont = intc + partial_rounds * L;
  const int32_t* mat_e = diag_mont + T * L;
  const int32_t* diag_small = mat_e + T * T;
  const int rounds = full_rounds + partial_rounds;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  small_mat_apply<T, L, FromShared>(x, mat_e);  // initial linear layer, deferred
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int pre = __ldg(plan + 2 * r), sbox = __ldg(plan + 2 * r + 1);
    if (r < half || r >= half + partial_rounds) {
      const int re = r < half ? r : r - partial_rounds;
#pragma unroll
      for (int e = 0; e < T; ++e) {
        add_const<FromShared>(x[e], ext + (re * T + e) * L);
        fold_upto<kMaxFolds>(x[e], rho, pre);
      }
      if constexpr (kWideState<T, L>) {  // one element at a time (mont.cuh kWideWords)
#pragma unroll
        for (int e = 0; e < T; ++e)
          p2_sbox<1, L>(reinterpret_cast<uint32_t(&)[1][L]>(x[e]), alpha, m, rho, sbox);
      } else {
        p2_sbox<T, L>(x, alpha, m, rho, sbox);
      }
      small_mat_apply<T, L, FromShared>(x, mat_e);
    } else {
      add_const<FromShared>(x[0], intc + (r - half) * L);
#pragma unroll
      for (int e = 1; e < T; ++e) carry_pass(x[e]);
#pragma unroll
      for (int e = 0; e < T; ++e) fold_upto<kMaxFolds>(x[e], rho, pre);
      p2_sbox<1, L>(reinterpret_cast<uint32_t(&)[1][L]>(x[0]), alpha, m, rho, sbox);
      uint32_t sigma[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        sigma[k] = x[0][k];
#pragma unroll
        for (int e = 1; e < T; ++e) sigma[k] += x[e][k];
      }
      if (small_diag) {
#pragma unroll
        for (int e = 0; e < T; ++e) {
          const uint32_t d = FromShared::load(diag_small + e);
#pragma unroll
          for (int k = 0; k < L; ++k) x[e][k] = sigma[k] + d * x[e][k];
        }
      } else {
#pragma unroll
        for (int e = 0; e < T; ++e) {
          mont_mul_staged(x[e], x[e], diag_mont + e * L, m);
#pragma unroll
          for (int k = 0; k < L; ++k) x[e][k] += sigma[k];
        }
      }
    }
  }
  const int exit_folds = __ldg(plan + 2 * rounds);
#pragma unroll
  for (int e = 0; e < T; ++e) {
    carry_pass(x[e]);
    fold_upto<kMaxFolds>(x[e], rho, exit_folds);
    mont_mul_staged(x[e], x[e], rho, m);  // rho = R mod p is the Montgomery form of 1
  }
  store_state<T, L>(out, x, B, b, m);
}

// ---- the one-word body (its word arithmetic: words.cuh) ----

// x <- M_E x, each row reduced below 2p.  Structured: M_E = circ(2 M4, M4,
// ..., M4) with M4 = (5 7 1 3; 4 6 1 1; 1 3 5 7; 1 1 4 6): z = M4 on each
// chunk of four by its addition chain (ePrint 2023/323, section 5.1),
// s_j = sum of the chunks' z_j, y = z + s.  Dense: each row of the buffer's
// small integers against the words in one 64-bit sum, reduced before the
// next row; the entries are read through a volatile pointer, so ptxas
// cannot keep all t^2 of them in registers across the round loop (it did,
// at 255 registers and spills for t = 16).
template <int T, bool STRUCTURED>
__device__ __forceinline__ void word_external(uint32_t (&x)[T], const int32_t* mat,
                                              const WordField& f) {
  if constexpr (STRUCTURED) {
    uint64_t z[T];
#pragma unroll
    for (int ch = 0; ch < T; ch += 4) {
      const uint64_t x0 = x[ch], x1 = x[ch + 1], x2 = x[ch + 2], x3 = x[ch + 3];
      const uint64_t t0 = x0 + x1, t1 = x2 + x3;
      const uint64_t t2 = 2 * x1 + t1, t3 = 2 * x3 + t0;
      const uint64_t t4 = 4 * t1 + t3, t5 = 4 * t0 + t2;
      z[ch] = t3 + t5;
      z[ch + 1] = t5;
      z[ch + 2] = t2 + t4;
      z[ch + 3] = t4;
    }
    uint64_t s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = z[j];
#pragma unroll
      for (int ch = 4; ch < T; ch += 4) s[j] += z[ch + j];
    }
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = reduce_wide(z[i] + s[i % 4], f);
  } else {
    const volatile int32_t* e = mat;
    uint32_t y[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint64_t z = 0;
#pragma unroll
      for (int j = 0; j < T; ++j) z += static_cast<uint64_t>(static_cast<uint32_t>(e[i * T + j])) * x[j];
      y[i] = reduce_wide(z, f);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = y[i];
  }
}

// A launch's chained overwrite sponge (ops/poseidon2.py
// overwrite_permute_p2): the rows of up to two canonical (k[v], 2, B) int32
// views (null: absent), view 0's then view 1's, each read through its own
// element strides (row, limb, lane), so the even and odd lanes of a tree
// level are two views with lane stride 2.  From a zero state, each chunk of
// ``width`` rows (the last may be shorter) is written over state rows
// [0, len(chunk)) and the state permuted; then rows [0, out_rows) are
// stored as an (out_rows, 2, B) plane.  One view of t rows, width t and
// out_rows t is the plain permutation.
struct SpongeIO {
  const int32_t* rows[2];
  long long stride[2][3];
  int k[2], width, out_rows;
};

// Row ``g`` of the views at lane ``b`` as one word below p (its two limbs
// joined).
__device__ __forceinline__ uint32_t view_row(const SpongeIO& io, int g, long long b) {
  // each field selected by itself: no address is taken of the parameter
  const bool second = g >= io.k[0];
  const int32_t* at = (second ? io.rows[1] : io.rows[0]) +
                      (g - (second ? io.k[0] : 0)) * (second ? io.stride[1][0] : io.stride[0][0]) +
                      b * (second ? io.stride[1][2] : io.stride[0][2]);
  const long long limb = second ? io.stride[1][1] : io.stride[0][1];
  return static_cast<uint32_t>(at[0]) | (static_cast<uint32_t>(at[limb]) << kLimbBits);
}

__host__ __device__ constexpr int top_bit(int a) { return a > 1 ? 1 + top_bit(a >> 1) : 0; }

// word_sbox's chain for an exponent known when compiling: unrolled, with no
// loop over the exponent's bits.
template <int ALPHA, int N>
__device__ __forceinline__ void word_sbox_fixed(uint32_t (&x)[N], const WordField& f) {
  uint32_t base[N];
#pragma unroll
  for (int e = 0; e < N; ++e) base[e] = x[e];
#pragma unroll
  for (int bit = top_bit(ALPHA) - 1; bit >= 0; --bit) {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = word_sub(word_mul(x[e], x[e], f), f);
    if ((ALPHA >> bit) & 1) {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = word_sub(word_mul(x[e], base[e], f), f);
    }
  }
}

// The S-box on N words: ALPHA, an exponent known when compiling, or 0 for
// ``alpha``.
template <int ALPHA, int N>
__device__ __forceinline__ void word_sbox_of(uint32_t (&x)[N], uint32_t alpha, const WordField& f) {
  if constexpr (ALPHA != 0) {
    word_sbox_fixed<ALPHA, N>(x, f);
  } else {
    word_sbox<N>(x, alpha, f);
  }
}

// One permutation of the one-word body on words below 2p, from its first
// M_E to its last (rows below 2p).
template <int T, bool STRUCTURED, int ALPHA>
__device__ __forceinline__ void word_permutation(uint32_t (&x)[T], const int32_t* c, int full_rounds,
                                                 int partial_rounds, uint32_t alpha, const WordField& f) {
  const int32_t* ext = c + 5;
  const int32_t* intc = ext + full_rounds * T;
  const int32_t* diag = intc + partial_rounds;
  const int32_t* mat = diag + T;
  const int half = full_rounds / 2;
  word_external<T, STRUCTURED>(x, mat, f);
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
    if (r < half || r >= half + partial_rounds) {
      const int re = r < half ? r : r - partial_rounds;
#pragma unroll
      for (int e = 0; e < T; ++e)
        x[e] = word_sub(word_sub(x[e], f) + static_cast<uint32_t>(FromShared::load(ext + re * T + e)), f);
      word_sbox_of<ALPHA, T>(x, alpha, f);
      word_external<T, STRUCTURED>(x, mat, f);
    } else {
      x[0] = word_sub(word_sub(x[0], f) + static_cast<uint32_t>(FromShared::load(intc + r - half)), f);
      word_sbox_of<ALPHA, 1>(reinterpret_cast<uint32_t(&)[1]>(x[0]), alpha, f);
      uint64_t s = 0;
#pragma unroll
      for (int e = 0; e < T; ++e) s += x[e];
      const uint32_t sigma = word_sub(reduce_wide(s, f), f);
#pragma unroll
      for (int e = 0; e < T; ++e)
        x[e] = sigma + word_sub(word_mul(x[e], static_cast<uint32_t>(FromShared::load(diag + e)), f), f);
    }
  }
}

template <int T, bool STRUCTURED, int ALPHA>
__global__ void __launch_bounds__(kThreads)
    poseidon2_word_kernel(const SpongeIO io, int32_t* __restrict__ out, long long B, int full_rounds,
                          int partial_rounds, uint32_t alpha, const int32_t* __restrict__ consts,
                          int words) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const WordField f{static_cast<uint32_t>(c[0]), static_cast<uint32_t>(c[1]), static_cast<uint32_t>(c[4])};
  const uint32_t to_word = static_cast<uint32_t>(c[2]), from_word = static_cast<uint32_t>(c[3]);
  const int rows = io.k[0] + io.k[1];

  // The chunk's rows enter through the product by 2^16 mod p (x R -> x R'),
  // over a zero state; after a permutation the carried rows, below 2p after
  // the last M_E, take one conditional subtraction (ops/bounds.py
  // _P2WordSim.run).
  uint32_t x[T];
  int n = min(io.width, rows);
#pragma unroll
  for (int e = 0; e < T; ++e) x[e] = e < n ? word_mul(view_row(io, e, b), to_word, f) : 0u;
  // The next chunk is taken at the loop's end: taken at its top, with the
  // rolled S-box, the permutation ran 20% slower (PERF.md).
#pragma unroll 1
  for (int lo = io.width;; lo += io.width) {
    word_permutation<T, STRUCTURED, ALPHA>(x, c, full_rounds, partial_rounds, alpha, f);
    if (lo >= rows) break;
    n = min(io.width, rows - lo);
#pragma unroll
    for (int e = 0; e < T; ++e)
      x[e] = e < n ? word_mul(view_row(io, lo + e, b), to_word, f) : word_sub(x[e], f);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (e < io.out_rows) {
      const uint32_t v = word_sub(word_mul(x[e], from_word, f), f);  // x R' -> x R, canonical
      out[(2 * e) * B + b] = static_cast<int32_t>(v & kLimbMask);
      out[(2 * e + 1) * B + b] = static_cast<int32_t>(v >> kLimbBits);
    }
  }
}

template <int T, int L>
int launch_p2(const int32_t* in, int32_t* out, long long B, int full_rounds, int partial_rounds,
              unsigned alpha, int small_diag, const int32_t* consts, int words, const int32_t* plan,
              unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon2_kernel<T, L>, bytes)) return err;
  poseidon2_kernel<T, L><<<blocks, kThreads, bytes, stream>>>(
      in, out, B, full_rounds, partial_rounds, alpha, small_diag, consts, words, plan, n0inv);
  return static_cast<int>(cudaGetLastError());
}

template <int T, bool STRUCTURED, int ALPHA>
int launch_p2_word(const SpongeIO& io, int32_t* out, long long B, int full_rounds, int partial_rounds,
                   unsigned alpha, const int32_t* consts, int words, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon2_word_kernel<T, STRUCTURED, ALPHA>, bytes)) return err;
  poseidon2_word_kernel<T, STRUCTURED, ALPHA><<<blocks, kThreads, bytes, stream>>>(
      io, out, B, full_rounds, partial_rounds, alpha, consts, words);
  return static_cast<int>(cudaGetLastError());
}

// The exponents of the one-word fields' default configs (KoalaBear 3,
// Mersenne31 5, BabyBear 7) take an unrolled S-box: the rolled one, inside
// the chunk loop, made ptxas add a uniform zero to most of its products and
// ran the leaf sponge 10% slower (PERF.md).  Any other alpha runs the
// rolled chain.
template <int T, bool STRUCTURED>
int launch_p2_word(const SpongeIO& io, int32_t* out, long long B, int full_rounds, int partial_rounds,
                   unsigned alpha, const int32_t* consts, int words, cudaStream_t stream) {
#define ALPHA(A_)                                                                                   \
  if (alpha == A_)                                                                                  \
    return launch_p2_word<T, STRUCTURED, A_>(io, out, B, full_rounds, partial_rounds, alpha, consts, \
                                             words, stream);
  ALPHA(3)
  ALPHA(5)
  ALPHA(7)
#undef ALPHA
  return launch_p2_word<T, STRUCTURED, 0>(io, out, B, full_rounds, partial_rounds, alpha, consts, words,
                                          stream);
}

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when the body
// has no instantiation at (t, L) or refuses the sponge arguments.  ``body``
// is 0 for the limb body (``consts`` the whole buffer, ``words`` its limb
// sections, ``plan`` the device fold table of ops/bounds.py p2_plan), 1 for
// the one-word body with dense rows and 2 for it with the structured M_E
// (``consts`` the word section, ``words`` its length).  The rest is the
// chained overwrite sponge (SpongeIO): ``in`` is view 0, then view 1, the
// views' rows, their element strides, the chunk width and the rows stored.
// The limb body runs the plain permutation alone: view 0 a contiguous
// (t, L, B) plane, width t, t rows stored.  Instantiations must match
// ops/poseidon2.py BODIES and INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_poseidon2(const int32_t* in, int32_t* out, long long B, int t, int L,
                                int body, int full_rounds, int partial_rounds, unsigned alpha,
                                int small_diag, const int32_t* consts, int words,
                                const int32_t* plan, unsigned n0inv, const int32_t* rows1, int k0,
                                int k1, long long row0_stride, long long limb0_stride,
                                long long lane0_stride, long long row1_stride, long long limb1_stride,
                                long long lane1_stride, int width, int out_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k0 < 0 || k1 < 0 || k0 + k1 < 1 || (k1 > 0 && rows1 == nullptr) || in == nullptr || width < 1 ||
      width > t || out_rows < 1 || out_rows > t)
    return -1;
  if (body == 0) {
    if (k0 != t || k1 != 0 || width != t || out_rows != t || lane0_stride != 1 || limb0_stride != B ||
        row0_stride != L * B)
      return -1;
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_p2<T_, L_>(in, out, B, full_rounds, partial_rounds, alpha, small_diag,    \
                                     consts, words, plan, n0inv, s);
    PAIR(3, 11)
    PAIR(4, 11)
    PAIR(8, 11)
    PAIR(8, 3)
    PAIR(12, 3)
    PAIR(8, 2)
    PAIR(3, 2)
#undef PAIR
    return -1;
  }
  if (L != 2) return -1;
  const sponge::SpongeIO io{{in, rows1},
                            {{row0_stride, limb0_stride, lane0_stride}, {row1_stride, limb1_stride, lane1_stride}},
                            {k0, k1}, width, out_rows};
#define WORD(T_, S_)                                                                              \
  if (t == T_)                                                                                    \
    return sponge::launch_p2_word<T_, S_>(io, out, B, full_rounds, partial_rounds, alpha, consts,  \
                                          words, s);
  if (body == 2) {
    WORD(16, true)
    WORD(8, true)
    return -1;
  }
  WORD(16, false)
  WORD(8, false)
  WORD(3, false)
#undef WORD
  return -1;
}
