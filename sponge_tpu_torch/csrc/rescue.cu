// Kernel 5: the Rescue-Prime permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_rescue.py (rescue_permute_fn, body
// _rescue_kernel).  2N half-rounds, alternating the exponent:
//     x <- x^alpha (or x^(1/alpha)) on every element;  x <- MDS x;  x += rc[h]
// then the exit: one Montgomery product by 1 (values below 2p) and a
// conditional subtraction, so the output is canonical.
//
// Both exponents run through one run-length ladder (mont.cuh pow_ladder):
// the schedule (ops/montgomery.py ladder_schedule) sits in the constant
// buffer and is read by loop index, exactly nbits - 1 squarings and
// popcount - 1 multiplies, 253 and 129 for the BLS12-381 inverse exponent.
// The TPU kernel's default for long exponents, a 4-bit fixed window, needs a
// 16-entry table of t x L words per thread (528 at t = 3, L = 11), more than
// a thread's 255 registers; the run-length ladder needs one copy of the base.
// The MDS rows are lazily accumulated dot products with one REDC each
// (mont_row).  ops/bounds.py check_rescue_bounds replays this schedule and
// proves every product input below R.
//
// What bounds it on the H100: integer multiply-add issue; about 14 x 2 x
// (3 + 382) products of 2 L^2 limb products per lane at BLS12-381, about 32x
// a Poseidon permutation, for 264 bytes of state.  Design: one thread per
// lane, state in registers, the ladder in lockstep over the t elements
// (independent chains), one rolled loop over the half-rounds so the ladder
// and the MDS are each inlined once.
//
// Constant buffer layout (int32, limb axis last; rescue/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (2N, t, L) | mds (t, t, L) |
// alpha schedule | inverse-alpha schedule.

#include "mont.cuh"

namespace sponge {

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    rescue_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                  int rounds, int n_alpha_runs, int n_inv_runs,
                  const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* rc = one + L;
  const int32_t* mds = rc + 2 * rounds * T * L;
  const int32_t* alpha_runs = mds + T * T * L;
  const int32_t* inv_runs = alpha_runs + n_alpha_runs;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
#pragma unroll 1
  for (int h = 0; h < 2 * rounds; ++h) {
    const bool inverse = h & 1;
    pow_ladder<T, L>(x, inverse ? inv_runs : alpha_runs, inverse ? n_inv_runs : n_alpha_runs, m,
                     one, 0);
    mat_apply<T, L>(x, mds, m);
#pragma unroll
    for (int e = 0; e < T; ++e) add_const(x[e], rc + (h * T + e) * L);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) mont_mul_const(x[e], x[e], one, m);
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_rescue(const int32_t* in, int32_t* out, long long B, int rounds, int n_alpha_runs,
                  int n_inv_runs, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  rescue_kernel<T, L><<<blocks, kThreads, 0, stream>>>(in, out, B, rounds, n_alpha_runs,
                                                       n_inv_runs, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  Instantiations must match
// INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_rescue(const int32_t* in, int32_t* out, long long B, int t, int L,
                             int rounds, int n_alpha_runs, int n_inv_runs,
                             const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 3 && L == 11)
    return sponge::launch_rescue<3, 11>(in, out, B, rounds, n_alpha_runs, n_inv_runs, consts,
                                        n0inv, s);
  if (t == 16 && L == 2)
    return sponge::launch_rescue<16, 2>(in, out, B, rounds, n_alpha_runs, n_inv_runs, consts,
                                        n0inv, s);
  if (t == 3 && L == 2)
    return sponge::launch_rescue<3, 2>(in, out, B, rounds, n_alpha_runs, n_inv_runs, consts,
                                       n0inv, s);
  return -1;
}
