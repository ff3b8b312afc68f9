// Kernel 8: the GMiMC-erf permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_gmimc.py (gmimc_permute_fn, body
// _gmimc_kernel).  Round r:
//     F = (x_0 + c_r)^alpha;  x_i += F for i = 1..t-1;  rotate left by one
// (the original x_0, without the constant, moves to the back); then the exit:
// one carry pass and one Montgomery product by 1 (values below 2p) and a
// conditional subtraction, so the output is canonical.
//
// Only the front element ever feeds a multiplier.  The kernel copies it, adds
// c_r with a carry (add_const) and raises the copy to alpha (mont_pow); F is
// added to the other t-1 elements word by word with no carry and no
// reduction, and those adds stay deferred for the whole permutation: an
// element's limb words grow by up to 2^24 per add (about 2^31.3 at t = 3,
// 226 rounds) and its value by F.  ops/bounds.py check_gmimc_bounds replays
// this schedule on exclusive value and word bounds and refuses a config
// whose words could reach 2^32 or whose front could reach R.
//
// The rotation is a register rename: the round loop is unrolled t times, so
// round r + j of a block takes its front from register x[j] and no state
// moves; after the loop the state sits rotated by rounds mod t and is turned
// back with at most t - 1 register moves of the whole state.
//
// What bounds it on the H100: integer multiply-add issue, and the latency of
// one serial chain: alpha = 5 is three dependent Montgomery products per
// round (678 at BLS12-381, 226 rounds), with only occupancy to hide them.
// Design: one thread per lane, state in registers, one rolled loop over
// blocks of t rounds.
//
// Constant buffer layout (int32, limb axis last; gmimc/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (rounds, L).

#include "mont.cuh"

namespace sponge {

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

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    gmimc_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                 int rounds, uint32_t alpha, const int32_t* __restrict__ consts,
                 uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* rc = one + L;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
#pragma unroll 1
  for (int r0 = 0; r0 < rounds; r0 += T) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (r0 + j < rounds) {
        uint32_t f[L];
#pragma unroll
        for (int k = 0; k < L; ++k) f[k] = x[j][k];
        add_const(f, rc + (r0 + j) * L);
        mont_pow(f, alpha, m);
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
#pragma unroll
  for (int e = 0; e < T; ++e) {
    carry_pass(x[e]);
    mont_mul_const(x[e], x[e], one, m);
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_gmimc(const int32_t* in, int32_t* out, long long B, int rounds, unsigned alpha,
                 const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  gmimc_kernel<T, L><<<blocks, kThreads, 0, stream>>>(in, out, B, rounds, alpha, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  Instantiations must match
// INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_gmimc(const int32_t* in, int32_t* out, long long B, int t, int L,
                            int rounds, unsigned alpha, const int32_t* consts, unsigned n0inv,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 3 && L == 11) return sponge::launch_gmimc<3, 11>(in, out, B, rounds, alpha, consts, n0inv, s);
  if (t == 8 && L == 3) return sponge::launch_gmimc<8, 3>(in, out, B, rounds, alpha, consts, n0inv, s);
  if (t == 3 && L == 2) return sponge::launch_gmimc<3, 2>(in, out, B, rounds, alpha, consts, n0inv, s);
  return -1;
}
