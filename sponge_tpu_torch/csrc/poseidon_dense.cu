// Kernel 2: the dense Poseidon permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_permute.py (pallas_permute_fn, body
// _permute_kernel): every round is ARK, x^alpha (every element in full
// rounds, element 0 in partial rounds) and the dense t x t MDS, each output
// row's t products summed in one set of 64-bit columns with one REDC.
//
// What bounds it on the H100: integer multiply-add issue.  A permutation at
// t = 3, L = 11, alpha = 17 is about 39 rounds x (up to 15 Montgomery
// products of 2 L^2 = 242 mul.wide.u32 + 64-bit adds, plus 3 MDS rows of
// 4 L^2 = 484) = several hundred thousand integer instructions per lane, for
// only 2 t L 4 = 264 bytes of state read and written; it is nowhere near the
// memory bound.  Design: one thread per sponge lane keeps the whole state in
// registers for all rounds (no shared memory, no synchronisation); loads and
// stores are coalesced over the batch axis; round constants are warp-uniform
// broadcasts from a small device buffer; limb loops are unrolled by
// templating on (t, L), round loops are not, to bound code size.  At a wide
// state (mont.cuh kWideState: the ~255-bit fields at t >= 4) the MDS rows run
// in a rolled loop (mds_apply: mat_apply_rows), so x, y and one row's
// columns are live and one row's code is inlined; the words are the same.
//
// Constant buffer layout (int32, limb axis last; poseidon/config.py
// constant_layout): p (L) | ark (R, t, L) | mds (t, t, L).

#include "mont.cuh"

namespace sponge {

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    poseidon_dense_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                          uint32_t alpha, int full_rounds, int partial_rounds,
                          const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int rounds = full_rounds + partial_rounds;
  const int32_t* ark = consts + L;
  const int32_t* mds = ark + rounds * T * L;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int32_t* ark_r = ark + r * T * L;
    if (r < half || r >= half + partial_rounds) {
      full_round<T, L>(x, ark_r, mds, alpha, m);
    } else {
#pragma unroll
      for (int e = 0; e < T; ++e) add_const(x[e], ark_r + e * L);
      mont_pow(x[0], alpha, m);
      mds_apply<T, L>(x, mds, m);
    }
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_dense(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds,
                 int partial_rounds, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  poseidon_dense_kernel<T, L><<<blocks, kThreads, 0, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  Instantiations must match
// INSTANTIATIONS in sponge_tpu_torch/ops/_build.py: every width of the
// default Poseidon tables (poseidon/params.py), the ~255-bit fields at rates
// 2-8 (t = 3..9, L = 11), Goldilocks at t = 8 and 12 (L = 3), the 31-bit
// fields at t = 16 (L = 2), and the 35-bit test field (3, 2).
extern "C" int sponge_poseidon_dense(const int32_t* in, int32_t* out, long long B, int t, int L,
                                     int alpha, int full_rounds, int partial_rounds,
                                     const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  PAIR(8, 3)
  PAIR(12, 3)
  PAIR(16, 2)
  PAIR(3, 2)
#undef PAIR
  return -1;
}
