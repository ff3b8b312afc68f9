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
// coalesced (t, L, B) loads and stores, limb loops unrolled by templating on
// (t, L).  Each block first copies the constant buffer (16.5 KB at
// BLS12-381 rate 2) to shared memory and reads every constant from there,
// the modulus included: read from global memory at a warp-uniform address,
// ptxas kept the modulus in uniform registers, and an IMAD.WIDE.U32 with a
// uniform operand takes no 64-bit addend, so every REDC product cost an
// IADD3 pair more (some 1,300 static IADD3; PERF.md).  The S-boxes square
// with mont_sqr (L (L+1) / 2 + L^2 limb products against mont_mul's 2 L^2)
// and a full round raises its t elements in lockstep (mont.cuh pow_sqr, as
// the TPU kernel's _pow_alpha_multi does).  A sparse round's linear layer
// is one fully unrolled pass over the constants' limbs (sparse_linear): the
// row0 dot and both col0 products accumulate side by side, each with its
// REDC steps interleaved, and x_i enters its product's columns instead of a
// separate carry chain.  Every other layer has one call site: a rolled loop
// over stages (the linear layer of the stage before, then a full round's ARK
// and S-boxes, or the whole partial phase), so the MDS and D share one
// inlined mat_apply and the full rounds one S-box chain.
//
// Constant buffer layout (int32, limb axis last; poseidon/config.py
// constant_layout): p (L) | ark (R, t, L) | mds (t, t, L) |
// chat (R_P-1, t, L) | row0 (R_P-1, t, L) | col0 (R_P-1, t-1, L) | D (t, t, L).

#include "mont.cuh"

namespace sponge {

// The linear layer of one sparse round: x0' = row . x (the t products summed
// in one set of columns) and x_i' = x_i + col_i * x0 for i >= 1, in one pass
// over the constants' limbs with all t REDCs interleaved.  x_i is added to
// the columns col_i * x0 leaves after its last REDC step (x_i R before the
// division), so the carried words equal mont_mul_const then add_lazy's.
template <int T, int L>
__device__ __forceinline__ void sparse_linear(uint32_t (&x)[T][L], const int32_t* __restrict__ row,
                                              const int32_t* __restrict__ col, const Modulus<L>& m) {
  uint64_t acc[T][L];
#pragma unroll
  for (int e = 0; e < T; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[e][k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t c = FromShared::load(row + j * L + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[0][k] += static_cast<uint64_t>(x[j][k]) * c;
    }
#pragma unroll
    for (int e = 1; e < T; ++e) {
      const uint32_t c = FromShared::load(col + (e - 1) * L + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[e][k] += static_cast<uint64_t>(x[0][k]) * c;
    }
#pragma unroll
    for (int e = 0; e < T; ++e) redc_step(acc[e], m);
  }
#pragma unroll
  for (int e = 1; e < T; ++e)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[e][k] += x[e][k];
#pragma unroll
  for (int e = 0; e < T; ++e) carry_out(x[e], acc[e]);
}

template <int T, int L>
__device__ __forceinline__ void add_round_constants(uint32_t (&x)[T][L], const int32_t* __restrict__ c) {
#pragma unroll
  for (int e = 0; e < T; ++e) add_const<FromShared>(x[e], c + e * L);
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads, 4)
    poseidon_opt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                        uint32_t alpha, int full_rounds, int partial_rounds,
                        const int32_t* __restrict__ consts, int words, uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, words);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;  // from the staged copy, so it lands in ordinary registers
  load_modulus<FromShared>(m, c, n0inv);
  const int rounds = full_rounds + partial_rounds;
  const int sparse_rounds = partial_rounds - 1;
  const int32_t* ark = c + L;
  const int32_t* mds = ark + rounds * T * L;
  const int32_t* chat = mds + T * T * L;
  const int32_t* row0 = chat + sparse_rounds * T * L;
  const int32_t* col0 = row0 + sparse_rounds * T * L;
  const int32_t* dense = col0 + sparse_rounds * (T - 1) * L;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  // Stage s = 0..R_F: the linear layer of the stage before (D after the
  // partial phase, the MDS after a full round), then full round s (s < half)
  // or s + R_P - 1 (s > half), or at s = half the partial phase; stage
  // R_F + 1 is the last full round's MDS alone.
#pragma unroll 1
  for (int s = 0;; ++s) {
    if (s > 0) mat_apply<T, L, FromShared>(x, s == half + 1 ? dense : mds, m);
    if (s > full_rounds) break;
    if (s != half) {
      add_round_constants<T, L>(x, ark + (s < half ? s : s + partial_rounds - 1) * T * L);
      pow_sqr<T, L>(x, alpha, m);
      continue;
    }
    // The first partial round: ARK and the element-0 S-box (its MDS is
    // folded into the sparse factors); then each sparse round adds c_r,
    // applies its linear layer and raises the new x0.
    add_round_constants<T, L>(x, ark + half * T * L);
#pragma unroll 1
    for (int r = 0;; ++r) {
      pow_sqr1<L>(x[0], alpha, m);
      if (r == sparse_rounds) break;
      add_round_constants<T, L>(x, chat + r * T * L);
      sparse_linear<T, L>(x, row0 + r * T * L, col0 + r * (T - 1) * L, m);
    }
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_opt(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds,
               int partial_rounds, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  // p | ark | mds | chat | row0 | col0 | D
  const int words = L + ((full_rounds + partial_rounds) * T + 2 * T * T + (partial_rounds - 1) * (3 * T - 1)) * L;
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon_opt_kernel<T, L>, bytes)) return err;
  poseidon_opt_kernel<T, L><<<blocks, kThreads, bytes, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, words, n0inv);
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
