// Kernel 1: the Poseidon permutation with sparse partial rounds over a
// (t, L, B) int32 plane; what batched_permute(backend="auto") launches.
//
// Replaces sponge_tpu/ops/pallas_cios.py (cios_permute_fn, bodies
// _permute_kernel / _permute_kernel_streams): full rounds as in kernel 2;
// the first partial round is ARK + x0^alpha; partial rounds 2..R_P go
// through the sparse factorization of poseidon/optimized.py
//     x += c_r;  x0' = row0_r . x  (one REDC);  x_i += col0_r[i] * x0  (i >= 1);
//     x0 = x0'^alpha
// and the accumulated dense matrix D is applied once after them
// (pallas_cios.py:1171-1228).  Elements 1..t-1 are never reduced in that
// phase and grow by about 2p per round; ops/bounds.py proves they stay
// below R (about 63p of R = 564p for BLS12-381 Fr), so no rho-fold is needed
// at 24-bit limbs.  The TPU kernel's emission variants (pipelined,
// wide_interleave, mds_mxu, lane_streams) have no counterpart: this kernel
// has one schedule.
//
// What bounds it on the H100: integer multiply-add issue, as kernel 2; the
// sparse phase cuts a partial round's linear layer from t^2 = 9 to
// 2t - 1 = 5 products.  Design: one thread per lane, state in registers,
// coalesced (t, L, B) loads and stores, warp-uniform constants from a device
// buffer, limb loops unrolled by templating on (t, L).
//
// Constant buffer layout (int32, limb axis last; poseidon/config.py
// constant_layout): p (L) | ark (R, t, L) | mds (t, t, L) |
// chat (R_P-1, t, L) | row0 (R_P-1, t, L) | col0 (R_P-1, t-1, L) | D (t, t, L).

#include "mont.cuh"

namespace sponge {

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    poseidon_opt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                        uint32_t alpha, int full_rounds, int partial_rounds,
                        const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int rounds = full_rounds + partial_rounds;
  const int sparse_rounds = partial_rounds - 1;
  const int32_t* ark = consts + L;
  const int32_t* mds = ark + rounds * T * L;
  const int32_t* chat = mds + T * T * L;
  const int32_t* row0 = chat + sparse_rounds * T * L;
  const int32_t* col0 = row0 + sparse_rounds * T * L;
  const int32_t* dense = col0 + sparse_rounds * (T - 1) * L;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  // One loop over all rounds, as in kernel 2: a second inlined copy of the
  // full-round body (a separate loop for the last full rounds) measured 9%
  // slower on the H100.
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r < half || r >= half + partial_rounds) {
      full_round<T, L>(x, ark + r * T * L, mds, alpha, m);
    } else if (r == half) {
      // First partial round: ARK and the element-0 S-box; its MDS is folded
      // into the sparse factors.
#pragma unroll
      for (int e = 0; e < T; ++e) add_const(x[e], ark + (r * T + e) * L);
      mont_pow(x[0], alpha, m);
    } else {
      const int s = r - half - 1;  // sparse round index
#pragma unroll
      for (int e = 0; e < T; ++e) add_const(x[e], chat + (s * T + e) * L);
      uint32_t x0[L];
      mont_row<T, L>(x0, x, row0 + s * T * L, m);
#pragma unroll
      for (int i = 1; i < T; ++i) {
        uint32_t prod[L];
        mont_mul_const(prod, x[0], col0 + (s * (T - 1) + i - 1) * L, m);
        add_lazy(x[i], prod);
      }
      mont_pow(x0, alpha, m);
#pragma unroll
      for (int k = 0; k < L; ++k) x[0][k] = x0[k];
    }
    if (r == half + partial_rounds - 1) mat_apply<T, L>(x, dense, m);
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_opt(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds,
               int partial_rounds, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  poseidon_opt_kernel<T, L><<<blocks, kThreads, 0, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes), same contract as sponge_poseidon_dense.
extern "C" int sponge_poseidon_opt(const int32_t* in, int32_t* out, long long B, int t, int L,
                                   int alpha, int full_rounds, int partial_rounds,
                                   const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partial_rounds < 2) return -1;
  if (t == 3 && L == 11)
    return sponge::launch_opt<3, 11>(in, out, B, alpha, full_rounds, partial_rounds, consts,
                                     n0inv, s);
  if (t == 3 && L == 2)
    return sponge::launch_opt<3, 2>(in, out, B, alpha, full_rounds, partial_rounds, consts,
                                    n0inv, s);
  return -1;
}
