// Kernel 1's two-word body: the sparse-factorized Poseidon permutation of
// poseidon_opt.cu over Goldilocks (p = 2^64 - 2^32 + 1) at t = 8 and 12,
// with the same rate I/O (poseidon_opt.cuh RateIO).
//
// The limb body holds a Goldilocks element in three 24-bit Montgomery limbs:
// a product is 2 L^2 = 18 widening products and a REDC carry pass.  Here an
// element is one 64-bit word in plain form, not necessarily below p, as in
// kernel 2's two-word body (poseidon_dense_words.cu): a product is the four
// 32-bit halves' products reduced by shifts and adds (words.cuh gl_mul), a
// row of t products one sum in five 32-bit words reduced once (gl_row).
// What bounds it is still integer multiply-add issue; the sparse phase cuts
// a partial round's linear layer from kernel 2's t^2 products to 2t - 1.
//
// The schedule is the limb body's stage loop.  A full round is ARK (gl_add)
// and the t S-boxes in lockstep (gl_sbox), then the MDS rows (gl_row), the
// matrix read through a volatile pointer so that ptxas cannot hoist its t^2
// entries into registers across the round loop (kernel 2 found the same).
// The first partial round is ARK and the element-0 S-box; each sparse round
// adds c^_r, forms x0' = row0_r . x as one gl_row and, for i >= 1,
// x_i + col0_r[i] x0 as one 128-bit product added to x_i in the same
// five-word accumulator (gl_mac) and reduced once (gl_reduce5), then raises
// x0'; the dense matrix D is applied once after the phase.
//
// Rate I/O: each element is read from the (t, 3, B) plane of canonical
// Montgomery limbs (or is zero in a fresh state), the absorbed rows, also
// canonical, are added by gl_add (the sum is below 2p, and gl_add's fix-up
// keeps it in a word), and the element is converted to plain form once, by
// a product by 2^-72 mod p.  Only rows [out_lo, out_hi) are stored,
// converted back by a product by 2^72 mod p and one conditional subtraction
// into canonical limbs, so every caller sees the plane the limb body gave.
//
// ops/bounds.py _OptGLSim replays this schedule on bounds before every
// launch.  Word constant layout (int32; ops/poseidon_opt.py word_constants):
// 2^-72 mod p, 2^72 mod p | ark (R, t) | mds (t, t) | chat (R_P-1, t) |
// row0 (R_P-1, t) | col0 (R_P-1, t-1) | D (t, t), each a 64-bit plain value
// in two 32-bit words, low first.

#include "mont.cuh"
#include "poseidon_opt.cuh"
#include "words.cuh"

namespace sponge {

// x = m x for a t x t matrix m, one gl_row a row.
template <int T>
__device__ __forceinline__ void gl_mat(uint64_t (&x)[T], const volatile uint64_t* m) {
  uint64_t y[T];
#pragma unroll
  for (int i = 0; i < T; ++i) y[i] = gl_row<T>(x, m + i * T);
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = y[i];
}

template <int T>
__device__ __forceinline__ void gl_add_constants(uint64_t (&x)[T], const uint64_t* c) {
#pragma unroll
  for (int e = 0; e < T; ++e) x[e] = gl_add(x[e], c[e]);
}

// poseidon_opt.cu load_absorb for words: the state (or zero), the rate rows
// added, each element converted x R -> x by one product by 2^-72 mod p.
template <int T>
__device__ __forceinline__ void gl_load_absorb(uint64_t (&x)[T], const int32_t* __restrict__ in, long long B,
                                               long long b, const RateIO io, uint64_t to_word) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    uint64_t v = io.fresh ? 0ull : gl_from_limbs(in + 3 * e * B + b, B);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int r = e - io.lo - w * io.k;
      if (io.rows[w] == nullptr || r < 0 || r >= io.k) continue;
      v = gl_add(v, gl_from_limbs(io.rows[w] + r * io.stride[w][0] + b * io.stride[w][2], io.stride[w][1]));
    }
    x[e] = gl_mul(v, to_word);
  }
}

// poseidon_opt.cu store_rows for words: rows [lo, hi) converted back to
// canonical limbs (gl_to_limbs) into an (hi - lo, 3, B) plane.
template <int T>
__device__ __forceinline__ void gl_store_rows(int32_t* __restrict__ out, const uint64_t (&x)[T], long long B,
                                              long long b, int lo, int hi, uint64_t from_word) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (e < lo || e >= hi) continue;
    gl_to_limbs(out + 3 * (e - lo) * B + b, B, x[e], from_word);
  }
}

// The two-word body's instantiation of kernel 1 (poseidon_opt.cu's limb
// body is poseidon_opt_kernel<T, L>).  Its launch bound asks for one block
// per SM, which lets ptxas give it the registers it wants: 158 at t = 12
// and 90 at t = 8 (3 and 5 blocks of 128 threads per SM).  Under the bound
// on threads alone ptxas held it to 96 and 72 registers, and it ran 1.35x
// and 1.12x slower (PERF.md section 6).
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    poseidon_opt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                        uint32_t alpha, int full_rounds, int partial_rounds,
                        const int32_t* __restrict__ words, int n_words, const RateIO io) {
  extern __shared__ int32_t c[];
  stage_constants(c, words, n_words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(c);
  const int rounds = full_rounds + partial_rounds;
  const int sparse_rounds = partial_rounds - 1;
  const uint64_t* ark = w + kGlHead;
  const volatile uint64_t* mds = ark + rounds * T;
  const uint64_t* chat = ark + rounds * T + T * T;
  const volatile uint64_t* row0 = chat + sparse_rounds * T;
  const uint64_t* col0 = chat + 2 * sparse_rounds * T;
  const volatile uint64_t* dense = col0 + sparse_rounds * (T - 1);
  const int half = full_rounds / 2;

  uint64_t x[T];
  gl_load_absorb<T>(x, in, B, b, io, w[0]);
  // Stage s = 0..R_F as in the limb body: the linear layer of the stage
  // before, then a full round, or at s = half the partial phase.
#pragma unroll 1
  for (int s = 0;; ++s) {
    if (s > 0) gl_mat<T>(x, s == half + 1 ? dense : mds);
    if (s > full_rounds) break;
    if (s != half) {
      gl_add_constants<T>(x, ark + (s < half ? s : s + partial_rounds - 1) * T);
      gl_sbox<T>(x, alpha);
      continue;
    }
    gl_add_constants<T>(x, ark + half * T);
#pragma unroll 1
    for (int r = 0;; ++r) {
      x[0] = gl_pow(x[0], alpha);
      if (r == sparse_rounds) break;
      gl_add_constants<T>(x, chat + r * T);
      const uint64_t x0 = gl_row<T>(x, row0 + r * T);
#pragma unroll
      for (int e = 1; e < T; ++e) {
        uint32_t n[5] = {static_cast<uint32_t>(x[e]), static_cast<uint32_t>(x[e] >> 32), 0, 0, 0};
        gl_mac(n, x[0], col0[r * (T - 1) + e - 1]);
        x[e] = gl_reduce5(n);
      }
      x[0] = x0;
    }
  }
  gl_store_rows<T>(out, x, B, b, io.out_lo, io.out_hi, w[1]);
}

template <int T>
int launch_opt_gl(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds, int partial_rounds,
                  const int32_t* words, int n_words, const RateIO& io, cudaStream_t stream) {
  // 2^-72, 2^72 | ark | mds | chat | row0 | col0 | D, two int32 a value
  const int values = kGlHead + (full_rounds + partial_rounds) * T + 2 * T * T + (partial_rounds - 1) * (3 * T - 1);
  if (n_words != 2 * values) return -1;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t bytes = static_cast<size_t>(n_words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon_opt_kernel<T>, bytes)) return err;
  poseidon_opt_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, words, n_words, io);
  return static_cast<int>(cudaGetLastError());
}

// The GL(t) lines must match ops/poseidon_opt.py BODIES["two-word"].
int launch_opt_words(const int32_t* in, int32_t* out, long long B, int t, int L, int alpha, int full_rounds,
                     int partial_rounds, const int32_t* words, int n_words, const RateIO& io, cudaStream_t stream) {
  if (L != 3) return -1;
#define GL(T_) \
  if (t == T_) return launch_opt_gl<T_>(in, out, B, alpha, full_rounds, partial_rounds, words, n_words, io, stream);
  GL(8)
  GL(12)
#undef GL
  return -1;
}

}  // namespace sponge
