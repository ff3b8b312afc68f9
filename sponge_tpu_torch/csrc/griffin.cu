// Kernel 6: the Griffin-pi permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_griffin.py (griffin_permute_fn, body
// _griffin_kernel).  Schedule (ePrint 2022/403):
//     x <- M_E x                                   (opening linear layer)
//     per round r:  y_0 = x_0^(1/alpha);  y_1 = x_1^alpha;
//                   y_i = x_i (L_i^2 + alpha_i L_i + beta_i), i = 2..t-1,
//                   L_2 = y_0 + y_1, L_i = (i-1) y_0 + y_1 + x_{i-1};
//                   x <- M_E y + rc[r]             (rc[rounds - 1] = 0)
// then the exit: one Montgomery product by 1 (values below 2p) and a
// conditional subtraction, so the output is canonical.
//
// x_0^(1/alpha) runs through the sliding-window chain (mont.cuh pow_window,
// the schedule of ops/montgomery.py window_schedule at griffin/config.py
// window), as the TPU kernel takes a 4-bit fixed window for long exponents
// (pallas_griffin.py:154-158): at BLS12-381 and w = 4, 251 squarings by
// mont_sqr and 62 multiplies where the binary ladder took 253 + 129 full
// products.  Its odd powers x^3 .. x^(2^w - 1) sit in this thread's slots
// of dynamic shared memory, after the staged constants.  x_1^alpha runs
// through pow_sqr1 and L_i^2 through mont_sqr.  The gates run from
// i = t-1 down to 2, so x_{i-1} is still the round's input when L_i reads
// it; L_i is a small-integer sum of limbs, carried once.  M_E (Poseidon2's
// small-integer matrix) is applied limb by limb in 32-bit words with no
// reduction (small_mat_apply); the rc add carries the words.  The linear
// layer multiplies values by its row sum (4 at t = 3, 48 at t = 8), so where
// ops/bounds.py check_griffin_bounds finds that values could reach R it asks
// for the post-linear reduction, one Montgomery product by 1 per element
// after each linear layer (Goldilocks t = 8), and the same replay proves
// every product input below R and every word below 2^32.
//
// What bounds it on the H100: widening multiply-add issue and the latency of
// the one inverse chain per lane (occupancy is the only latency hiding).
// Design: one thread per lane, state in registers, one rolled round loop
// (its first pass is the opening linear layer).  Each block first copies
// the constant buffer to shared memory and reads every constant there, the
// modulus included (from global memory at a warp-uniform address ptxas
// keeps the modulus in uniform registers and splits each REDC product's
// 64-bit accumulate into an IADD3 pair: kernel 1, PERF.md); the products by
// constants (alpha_i, the post-linear and exit products by 1) run fully
// unrolled from there (mont_mul_staged).
//
// Constant buffer layout (int32, limb axis last; griffin/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (rounds, t, L) |
// alpha_i (t-2, L) | beta_i (t-2, L) | M_E (t, t) | inverse-alpha window
// schedule.

#include "mont.cuh"

namespace sponge {

// x <- M_E x, then the rc row (carrying the words) or, with no row, a carry
// pass; then, if asked, a Montgomery product by 1 per element.
template <int T, int L>
__device__ __forceinline__ void griffin_linear(uint32_t (&x)[T][L], const int32_t* mat,
                                               const int32_t* rc_row, int reduce, const int32_t* one,
                                               const Modulus<L>& m) {
  small_mat_apply<T, L, FromShared>(x, mat);
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (rc_row != nullptr) {
      add_const<FromShared>(x[e], rc_row + e * L);
    } else {
      carry_pass(x[e]);
    }
    if (reduce) mont_mul_staged(x[e], x[e], one, m);
  }
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    griffin_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                   int rounds, uint32_t alpha, int w, int n_inv, int reduce,
                   const int32_t* __restrict__ consts, int words, uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;  // from the staged copy, so it lands in ordinary registers
  load_modulus<FromShared>(m, c, n0inv);
  const int32_t* one = c + L;
  const int32_t* rc = one + L;
  const int32_t* qa = rc + rounds * T * L;
  const int32_t* qb = qa + (T - 2) * L;
  const int32_t* mat = qb + (T - 2) * L;
  const int32_t* inv_sched = mat + T * T;
  uint32_t* table = reinterpret_cast<uint32_t*>(c + words) + threadIdx.x;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  // Pass -1 is the opening linear layer alone, so the linear layer is
  // inlined once.
#pragma unroll 1
  for (int r = -1; r < rounds; ++r) {
    if (r >= 0) {
      uint32_t y0[1][L], y1[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        y0[0][k] = x[0][k];
        y1[k] = x[1][k];
      }
      pow_window<1, L, FromShared>(y0, inv_sched, n_inv, w, table, m);
      pow_sqr1<L>(y1, alpha, m);
#pragma unroll
      for (int i = T - 1; i >= 2; --i) {
        uint32_t li[L], quad[L], al[L];
#pragma unroll
        for (int k = 0; k < L; ++k)
          li[k] = static_cast<uint32_t>(i - 1) * y0[0][k] + y1[k] + (i >= 3 ? x[i - 1][k] : 0u);
        carry_pass(li);
        mont_sqr(quad, li, m);
        mont_mul_staged(al, li, qa + (i - 2) * L, m);
        add_lazy(quad, al);
        add_const<FromShared>(quad, qb + (i - 2) * L);
        mont_mul(x[i], x[i], quad, m);
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        x[0][k] = y0[0][k];
        x[1][k] = y1[k];
      }
    }
    griffin_linear<T, L>(x, mat, r >= 0 ? rc + r * T * L : nullptr, reduce, one, m);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) mont_mul_staged(x[e], x[e], one, m);
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_griffin(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha, int w,
                   int n_inv, int reduce, const int32_t* consts, int words, unsigned n0inv,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t shared = static_cast<size_t>(words) * sizeof(int32_t) + window_table_bytes(1, L, w);
  if (const int err = allow_dynamic_shared(griffin_kernel<T, L>, shared)) return err;
  griffin_kernel<T, L><<<blocks, kThreads, shared, stream>>>(in, out, B, rounds, alpha, w, n_inv,
                                                             reduce, consts, words, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when (t, L) has
// no instantiation.  ``words`` is the constant buffer's length.
// Instantiations must match INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_griffin(const int32_t* in, int32_t* out, long long B, int t, int L,
                              int rounds, unsigned alpha, int w, int n_inv, int reduce,
                              const int32_t* consts, int words, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_griffin<T_, L_>(in, out, B, rounds, alpha, w, n_inv, reduce, consts, words, \
                                          n0inv, s);
  PAIR(3, 11)
  PAIR(4, 11)
  PAIR(8, 11)
  PAIR(8, 3)
  PAIR(12, 3)
  PAIR(3, 2)
#undef PAIR
  return -1;
}
