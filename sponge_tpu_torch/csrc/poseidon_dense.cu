// Kernel 2: the dense Poseidon permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_permute.py (pallas_permute_fn, body
// _permute_kernel): every round is ARK, x^alpha (every element in full
// rounds, element 0 in partial rounds) and the dense t x t MDS.  Three
// bodies; the host picks one by the field (ops/poseidon_dense.py body):
// this file's limb body, and the one-word (fields below 2^31) and two-word
// (Goldilocks) bodies of poseidon_dense_words.cu, which this entry point
// dispatches to.
//
// What bounds it on the H100: integer multiply-add issue.  A permutation at
// t = 3, L = 11, alpha = 17 is about 39 rounds x (up to 15 Montgomery
// products or squarings, plus 3 MDS rows of 4 L^2 = 484 limb products) =
// some 10^5 widening multiply-adds per lane, for only 2 t L 4 = 264 bytes of
// state read and written; it is nowhere near the memory bound.
//
// The limb body (poseidon_dense_kernel; the ~255-bit fields and the 35-bit
// test field): 24-bit limbs, Montgomery R = 2^(24 L), one thread per lane,
// the state in registers for all rounds, coalesced (t, L, B) loads and
// stores; each output row's t products are summed in one set of 64-bit
// columns with one REDC.  Each block first copies p | ark | mds to shared
// memory (5.6 KB at BLS12-381 rate 2) and reads every constant from there,
// the modulus included, as kernel 1 does: read from global memory at a
// warp-uniform address, the modulus sat in uniform registers and every REDC
// product cost an IADD3 pair more.  A full round raises its t elements in
// lockstep (mont.cuh pow_sqr: t independent chains, squaring by mont_sqr);
// a partial round's element 0 alone (pow_sqr1).  At the wide states
// (mont.cuh kWideState: the ~255-bit fields at t >= 4) one chain raises
// x[0] and the state rotates by one, t times a full round, so one chain is
// inlined for both kinds of round (cicc segfaulted on (9, 11) with t + 1
// chains inlined), and the MDS rows run in a rolled loop (mds_apply:
// mat_apply_rows), so one row's columns are live.  mont_sqr's words equal
// mont_mul's, so the output equals the earlier mont_pow schedule's bit for
// bit.  One MDS call site serves both kinds of round.  No launch bound asks
// for blocks per SM: at t = 3 a bound of 3 or 4 made ptxas spill and the
// kernel slower than none (PERF.md section 6, "launch bound at t = 3").
//
// Constant buffer layout (int32, limb axis last; poseidon/config.py
// constant_layout, whose first three sections this body stages): p (L) |
// ark (R, t, L) | mds (t, t, L).

#include "mont.cuh"

namespace sponge {

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    poseidon_dense_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                          uint32_t alpha, int full_rounds, int partial_rounds,
                          const int32_t* __restrict__ consts, int words, uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;  // from the staged copy, so it lands in ordinary registers
  load_modulus<FromShared>(m, c, n0inv);
  const int rounds = full_rounds + partial_rounds;
  const int32_t* ark = c + L;
  const int32_t* mds = ark + rounds * T * L;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) add_const<FromShared>(x[e], ark + (r * T + e) * L);
    const bool partial = r >= half && r < half + partial_rounds;
    if constexpr (kWideState<T, L>) {
      // One chain inlined: x[0] raised, then (full round) the state rotated
      // by one, T times, which leaves every element raised and in its place.
#pragma unroll 1
      for (int s = 0; s < (partial ? 1 : T); ++s) {
        pow_sqr1<L>(x[0], alpha, m);
        if (!partial) {
          uint32_t v[L];
#pragma unroll
          for (int k = 0; k < L; ++k) v[k] = x[0][k];
          shift_in<T, L>(x, v);
        }
      }
    } else if (partial) {
      pow_sqr1<L>(x[0], alpha, m);
    } else {
      pow_sqr<T, L>(x, alpha, m);
    }
    mds_apply<T, L, FromShared>(x, mds, m);
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_dense(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds,
                 int partial_rounds, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const int words = L + ((full_rounds + partial_rounds) * T + T * T) * L;  // p | ark | mds
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon_dense_kernel<T, L>, bytes)) return err;
  poseidon_dense_kernel<T, L><<<blocks, kThreads, bytes, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, words, n0inv);
  return static_cast<int>(cudaGetLastError());
}

// The word bodies (poseidon_dense_words.cu): -1 where the body has no
// instantiation at (t, L).
int launch_dense_words(int body, const int32_t* in, int32_t* out, long long B, int t, int L, int alpha,
                       int full_rounds, int partial_rounds, const int32_t* words, int n_words,
                       cudaStream_t stream);

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when the body
// has no instantiation at (t, L).  ``body`` is 0 for the limb body
// (``consts`` kernel_constants, the limb buffer), 1 for the one-word body
// and 2 for the two-word body (``words`` ops/poseidon_dense.py
// word_constants, ``n_words`` its length).  The limb body's PAIR(t, L) lines
// (and the word bodies' WORD and GL lines in poseidon_dense_words.cu) must
// match ops/poseidon_dense.py BODIES and INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py: the limb body at the ~255-bit fields'
// default widths (t = 3..9, L = 11) and the 35-bit test field (3, 2).
extern "C" int sponge_poseidon_dense(const int32_t* in, int32_t* out, long long B, int t, int L,
                                     int alpha, int full_rounds, int partial_rounds,
                                     const int32_t* consts, unsigned n0inv, int body,
                                     const int32_t* words, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body != 0)
    return sponge::launch_dense_words(body, in, out, B, t, L, alpha, full_rounds, partial_rounds, words,
                                      n_words, s);
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_dense<T_, L_>(in, out, B, alpha, full_rounds, partial_rounds, consts, n0inv, s);
  PAIR(3, 11)
  PAIR(4, 11)
  PAIR(5, 11)
  PAIR(6, 11)
  PAIR(7, 11)
  PAIR(8, 11)
  PAIR(9, 11)
  PAIR(3, 2)
#undef PAIR
  return -1;
}
