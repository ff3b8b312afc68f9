// Kernel 7: the Anemoi permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_anemoi.py (anemoi_permute_fn, body
// _anemoi_kernel).  The state is two columns of l = t/2 elements, X = x[0..l)
// and Y = x[l..t).  Round r (ePrint 2022/840):
//     X += rc_x[r];  Y += rc_y[r]
//     diffusion: X <- M_x X;  Y <- M_x rot_left_1(Y);  Y += X;  X += Y
//     open Flystel on every pair (x, y):
//         u = x - (g y^2 + g^-1);  v = y - u^(1/alpha);  (x, y) <- (u + g v^2, v)
// then a closing diffusion and the exit: one Montgomery product by 1 (values
// below 2p) and a conditional subtraction, so the output is canonical.
//
// The subtractions are products by the negated constants -g and -1 plus the
// constant -g^-1, as in the TPU kernel, so every operand stays a non-negative
// lazily reduced value and no borrow is needed.  The M_x rows are lazily
// summed products with one REDC each (mat_apply_rolled; M_x is the identity
// at l = 1 and skipped); the PHT adds are carried but not reduced.  The
// Flystel squares with mont_sqr.  The inverse S-box runs over all l pairs in
// lockstep through the sliding-window chain (mont.cuh pow_window, the
// schedule of ops/montgomery.py window_schedule at anemoi/config.py window),
// l independent chains per lane, the odd powers x^3 .. x^(2^w - 1) in
// shared memory (264 bytes per thread at l = 2, L = 11, w = 3: 252
// squarings and 66 multiplies where the binary ladder took 253 + 129 full
// products).  At l = 1 nothing reduces between the PHT adds, so values grow
// round over round; where ops/bounds.py check_anemoi_bounds finds they could
// reach R it asks for the post-PHT reduction, one Montgomery product by 1
// per element after each diffusion (BLS12-381 at l = 1), and the same replay
// proves every product input below R.
//
// What bounds it on the H100: widening multiply-add issue, l x 63,800 limb
// products of the inverse S-box per round at BLS12-381.  Design: one thread
// per lane, state in registers, one rolled round loop that also runs the
// closing diffusion, so the diffusion is inlined once.
//
// The wide states of more than two pairs (kPairwise: mont.cuh kWideState at
// l >= 3, l = 3 and 4 over the ~255-bit fields, 66 and 88 words a lane) run
// the Flystel one pair at a time in a rolled loop (pair 0, then both
// columns shifted: shift_in), so the chain holds one base and one table
// (anemoi/config.py window asks window_for for one chain), not l of each.
// Every pair takes the same products and carries as in lockstep, so the
// words, and the replay, are the same.  l = 2 at L = 11 (44 words) keeps
// the lockstep pair it was tuned at (128 registers, 4 blocks per SM).
//
// Constant buffer layout (int32, limb axis last; anemoi/config.py
// constant_layout): p (L) | one = R mod p (L) | rc_x (rounds, l, L) |
// rc_y (rounds, l, L) | M_x (l, l, L) | g, -g, -g^-1, -1 (4, L) |
// inverse-alpha window schedule.

#include "mont.cuh"

namespace sponge {

// x = M x for an N x N matrix of Montgomery constants (row-major, L limbs
// each): per row the N products summed lazily in the same columns, one REDC.
// As in mont_mul_const, the loop over the constants' limbs stays rolled (they
// are read by loop index): with it unrolled, nvcc 12.9's cicc crashed on
// this kernel at L = 11.
template <int N, int L>
__device__ __forceinline__ void mat_apply_rolled(uint32_t (&x)[N][L], const int32_t* __restrict__ mat,
                                                 const Modulus<L>& m) {
  uint32_t y[N][L];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uint64_t acc[L];
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t cji = ldc(mat + (r * N + j) * L + i);
#pragma unroll
        for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(x[j][k]) * cji;
      }
      redc_step(acc, m);
    }
    carry_out(y[r], acc);
  }
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < L; ++k) x[r][k] = y[r][k];
}

template <int N, int L>
__device__ __forceinline__ void anemoi_diffusion(uint32_t (&x)[N][L], uint32_t (&y)[N][L],
                                                 const int32_t* __restrict__ mat, int reduce,
                                                 const int32_t* __restrict__ one,
                                                 const Modulus<L>& m) {
  if constexpr (N > 1) {
    uint32_t yr[N][L];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < L; ++k) yr[i][k] = y[(i + 1) % N][k];
    mat_apply_rolled<N, L>(x, mat, m);
    mat_apply_rolled<N, L>(yr, mat, m);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < L; ++k) y[i][k] = yr[i][k];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    add_lazy(y[i], x[i]);
    add_lazy(x[i], y[i]);
    if (reduce) {
      mont_mul_const(x[i], x[i], one, m);
      mont_mul_const(y[i], y[i], one, m);
    }
  }
}

// The open Flystel on N pairs (x[j], y[j]) in lockstep: u = x + (-g) y^2 +
// (-g^-1), v = y + (-1) u^(1/alpha), (x, y) <- (u + g v^2, v).
template <int N, int L>
__device__ __forceinline__ void flystel(uint32_t (&x)[N][L], uint32_t (&y)[N][L], const int32_t* g,
                                        const int32_t* neg_g, const int32_t* neg_ginv,
                                        const int32_t* neg_one, const int32_t* inv_sched, int n_inv,
                                        int w, uint32_t* table, const Modulus<L>& m) {
  uint32_t u[N][L], lad[N][L];
#pragma unroll
  for (int j = 0; j < N; ++j) {  // u = x + (-g) y^2 + (-g^-1)
    uint32_t sq[L];
    mont_sqr(sq, y[j], m);
    mont_mul_const(sq, sq, neg_g, m);
#pragma unroll
    for (int k = 0; k < L; ++k) u[j][k] = x[j][k];
    add_lazy(u[j], sq);
    add_const(u[j], neg_ginv);
#pragma unroll
    for (int k = 0; k < L; ++k) lad[j][k] = u[j][k];
  }
  pow_window<N, L>(lad, inv_sched, n_inv, w, table, m);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mont_mul_const(lad[j], lad[j], neg_one, m);
    add_lazy(y[j], lad[j]);  // v = y + (-1) u^(1/alpha)
    uint32_t sq[L];
    mont_sqr(sq, y[j], m);
    mont_mul_const(sq, sq, g, m);
#pragma unroll
    for (int k = 0; k < L; ++k) x[j][k] = u[j][k];
    add_lazy(x[j], sq);  // w = u + g v^2
  }
}

template <int T, int L>
constexpr bool kPairwise = kWideState<T, L> && T / 2 > 2;

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    anemoi_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                  int rounds, int w, int n_inv, int reduce, const int32_t* __restrict__ consts,
                  uint32_t n0inv) {
  extern __shared__ uint32_t table_base[];
  constexpr int N = T / 2;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* rc_x = one + L;
  const int32_t* rc_y = rc_x + rounds * N * L;
  const int32_t* mat = rc_y + rounds * N * L;
  const int32_t* g = mat + N * N * L;
  const int32_t* neg_g = g + L;
  const int32_t* neg_ginv = neg_g + L;
  const int32_t* neg_one = neg_ginv + L;
  const int32_t* inv_sched = neg_one + L;
  uint32_t* table = table_base + threadIdx.x;

  uint32_t s[T][L], x[N][L], y[N][L];
  load_state<T, L>(s, in, B, b);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < L; ++k) {
      x[j][k] = s[j][k];
      y[j][k] = s[N + j][k];
    }
  // rounds + 1 passes over one inlined diffusion: the last pass is the
  // closing diffusion alone.
#pragma unroll 1
  for (int r = 0;; ++r) {
    if (r < rounds) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        add_const(x[j], rc_x + (r * N + j) * L);
        add_const(y[j], rc_y + (r * N + j) * L);
      }
    }
    anemoi_diffusion<N, L>(x, y, mat, reduce, one, m);
    if (r == rounds) break;
    if constexpr (kPairwise<T, L>) {
#pragma unroll 1
      for (int j = 0; j < N; ++j) {
        uint32_t px[1][L], py[1][L];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          px[0][k] = x[0][k];
          py[0][k] = y[0][k];
        }
        flystel<1, L>(px, py, g, neg_g, neg_ginv, neg_one, inv_sched, n_inv, w, table, m);
        shift_in<N, L>(x, px[0]);
        shift_in<N, L>(y, py[0]);
      }
    } else {
      flystel<N, L>(x, y, g, neg_g, neg_ginv, neg_one, inv_sched, n_inv, w, table, m);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mont_mul_const(s[j], x[j], one, m);
    mont_mul_const(s[N + j], y[j], one, m);
  }
  store_state<T, L>(out, s, B, b, m);
}

template <int T, int L>
int launch_anemoi(const int32_t* in, int32_t* out, long long B, int rounds, int w, int n_inv,
                  int reduce, const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t shared = window_table_bytes(kPairwise<T, L> ? 1 : T / 2, L, w);
  if (const int err = allow_dynamic_shared(anemoi_kernel<T, L>, shared)) return err;
  anemoi_kernel<T, L><<<blocks, kThreads, shared, stream>>>(in, out, B, rounds, w, n_inv, reduce,
                                                            consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when (t, L) has
// no instantiation.  Instantiations must match INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_anemoi(const int32_t* in, int32_t* out, long long B, int t, int L,
                             int rounds, int w, int n_inv, int reduce, const int32_t* consts,
                             unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_anemoi<T_, L_>(in, out, B, rounds, w, n_inv, reduce, consts, n0inv, s);
  PAIR(2, 11)
  PAIR(4, 11)
  PAIR(6, 11)
  PAIR(8, 11)
  PAIR(6, 3)
  PAIR(8, 3)
  PAIR(10, 3)
  PAIR(12, 3)
  PAIR(4, 2)
#undef PAIR
  return -1;
}
