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
// x_0^(1/alpha) runs through the run-length ladder (mont.cuh pow_ladder, the
// schedule of ops/montgomery.py ladder_schedule in the constant buffer): 253
// squarings and 129 multiplies at BLS12-381, one serial chain per lane.  The
// gates run from i = t-1 down to 2, so x_{i-1} is still the round's input
// when L_i reads it; L_i is a small-integer sum of limbs, carried once.  M_E
// (Poseidon2's small-integer matrix) is applied limb by limb in 32-bit words
// with no reduction (small_mat_apply); the rc add carries the words.  The
// linear layer multiplies values by its row sum (4 at t = 3, 48 at t = 8), so
// where ops/bounds.py check_griffin_bounds finds that values could reach R
// it asks for the post-linear reduction, one Montgomery product by 1 per
// element after each linear layer (Goldilocks t = 8), and the same replay
// proves every product input below R and every word below 2^32.
//
// What bounds it on the H100: integer multiply-add issue and the latency of
// the one ladder chain per lane (occupancy is the only latency hiding).
// Design: one thread per lane, state in registers, one rolled round loop
// (its first pass is the opening linear layer).
//
// Constant buffer layout (int32, limb axis last; griffin/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (rounds, t, L) |
// alpha_i (t-2, L) | beta_i (t-2, L) | M_E (t, t) | inverse-alpha schedule.

#include "mont.cuh"

namespace sponge {

// x <- M_E x, then the rc row (carrying the words) or, with no row, a carry
// pass; then, if asked, a Montgomery product by 1 per element.
template <int T, int L>
__device__ __forceinline__ void griffin_linear(uint32_t (&x)[T][L], const int32_t* __restrict__ mat,
                                               const int32_t* __restrict__ rc_row, int reduce,
                                               const int32_t* __restrict__ one,
                                               const Modulus<L>& m) {
  small_mat_apply<T, L>(x, mat);
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (rc_row != nullptr) {
      add_const(x[e], rc_row + e * L);
    } else {
      carry_pass(x[e]);
    }
    if (reduce) mont_mul_const(x[e], x[e], one, m);
  }
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    griffin_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                   int rounds, uint32_t alpha, int n_inv_runs, int reduce,
                   const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* rc = one + L;
  const int32_t* qa = rc + rounds * T * L;
  const int32_t* qb = qa + (T - 2) * L;
  const int32_t* mat = qb + (T - 2) * L;
  const int32_t* inv_runs = mat + T * T;

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
      pow_ladder<1, L>(y0, inv_runs, n_inv_runs, m, one, 0);
      mont_pow(y1, alpha, m);
#pragma unroll
      for (int i = T - 1; i >= 2; --i) {
        uint32_t li[L], quad[L], al[L];
#pragma unroll
        for (int k = 0; k < L; ++k)
          li[k] = static_cast<uint32_t>(i - 1) * y0[0][k] + y1[k] + (i >= 3 ? x[i - 1][k] : 0u);
        carry_pass(li);
        mont_mul(quad, li, li, m);
        mont_mul_const(al, li, qa + (i - 2) * L, m);
        add_lazy(quad, al);
        add_const(quad, qb + (i - 2) * L);
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
  for (int e = 0; e < T; ++e) mont_mul_const(x[e], x[e], one, m);
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_griffin(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha,
                   int n_inv_runs, int reduce, const int32_t* consts, unsigned n0inv,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  griffin_kernel<T, L><<<blocks, kThreads, 0, stream>>>(in, out, B, rounds, alpha, n_inv_runs,
                                                        reduce, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  Instantiations must match
// INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_griffin(const int32_t* in, int32_t* out, long long B, int t, int L,
                              int rounds, unsigned alpha, int n_inv_runs, int reduce,
                              const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 3 && L == 11)
    return sponge::launch_griffin<3, 11>(in, out, B, rounds, alpha, n_inv_runs, reduce, consts,
                                         n0inv, s);
  if (t == 8 && L == 3)
    return sponge::launch_griffin<8, 3>(in, out, B, rounds, alpha, n_inv_runs, reduce, consts,
                                        n0inv, s);
  if (t == 3 && L == 2)
    return sponge::launch_griffin<3, 2>(in, out, B, rounds, alpha, n_inv_runs, reduce, consts,
                                        n0inv, s);
  return -1;
}
