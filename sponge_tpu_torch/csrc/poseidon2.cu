// Kernel 3: the Poseidon2 permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_p2.py (p2_permute_fn, body _p2_kernel).
// Schedule (ePrint 2023/323): M_E; R_F/2 external rounds (x += rc, x^alpha
// on every element, M_E); R_P internal rounds (x0 += rc, x0^alpha,
// M_I = J + diag(mu - 1)); R_F/2 external rounds; then the exit.
//
// The linear layers never reduce.  M_E has small non-negative integer
// entries, so a row is the sum of e_ij * x_j over the 24-bit limbs in 32-bit
// words, left deferred (a word reaches 80 * 2^24 at t = 16).  M_I is the
// shared limb sum sigma plus (mu_i - 1) x_i: a plain integer scale when every
// mu_i - 1 is below 16 (t = 2, 3), else one constant Montgomery product per
// element.  The next round's constant add is a carry pass that puts the
// whole excess in the top word; values then exceed R = 2^(24 L) in the
// internal phase (sigma sums all elements every round), so a top-carry
// rho-fold brings them back: c = value >> 24L, value += c * (rho - R) with
// rho = R mod p, which keeps the value mod p.  The S-box products can also
// end between R and R + p and are folded.  How many folds each static site
// needs is derived on the host by an exact replay of this schedule on
// integer bounds (ops/bounds.py p2_plan) and passed in; the same replay
// checks every word below 2^32 and every product input below R.  Exit: a
// carry pass and its folds, one Montgomery product by 1 (below 2p), then a
// conditional subtraction: canonical output.
//
// What bounds it on the H100: integer multiply-add issue (the S-box
// Montgomery products; the linear layers are 32-bit multiply-adds).  Design:
// one thread per lane, state in registers for all rounds, coalesced
// (t, L, B) loads and stores, warp-uniform constants from a device buffer,
// the S-box ladder in lockstep over the elements (independent chains for
// the scheduler), one rolled loop over all rounds.
//
// Constant buffer layout (int32, limb axis last; poseidon2/config.py
// constant_layout): p (L) | rho (L) | ext rc (R_F, t, L) | int rc (R_P, L) |
// diag_mont (t, L) | mat_e (t, t) | diag_small (t) | alpha ladder schedule.

#include "mont.cuh"

namespace sponge {

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    poseidon2_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                     int full_rounds, int partial_rounds, int n_runs, int small_diag,
                     int fold_ext, int fold_int, int fold_sbox_ext, int fold_sbox_int,
                     int fold_exit, const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* rho = consts + L;
  const int32_t* ext = rho + L;
  const int32_t* intc = ext + full_rounds * T * L;
  const int32_t* diag_mont = intc + partial_rounds * L;
  const int32_t* mat_e = diag_mont + T * L;
  const int32_t* diag_small = mat_e + T * T;
  const int32_t* runs = diag_small + T;
  const int half = full_rounds / 2;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  small_mat_apply<T, L>(x, mat_e);  // initial linear layer, deferred
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
    if (r < half || r >= half + partial_rounds) {
      const int re = r < half ? r : r - partial_rounds;
#pragma unroll
      for (int e = 0; e < T; ++e) {
        add_const(x[e], ext + (re * T + e) * L);
        fold(x[e], rho, fold_ext);
      }
      pow_ladder<T, L>(x, runs, n_runs, m, rho, fold_sbox_ext);
      small_mat_apply<T, L>(x, mat_e);
    } else {
      add_const(x[0], intc + (r - half) * L);
#pragma unroll
      for (int e = 1; e < T; ++e) carry_pass(x[e]);
#pragma unroll
      for (int e = 0; e < T; ++e) fold(x[e], rho, fold_int);
      uint32_t x0[1][L];
#pragma unroll
      for (int k = 0; k < L; ++k) x0[0][k] = x[0][k];
      pow_ladder<1, L>(x0, runs, n_runs, m, rho, fold_sbox_int);
      uint32_t sigma[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        x[0][k] = x0[0][k];
        sigma[k] = x0[0][k];
#pragma unroll
        for (int e = 1; e < T; ++e) sigma[k] += x[e][k];
      }
      if (small_diag) {
#pragma unroll
        for (int e = 0; e < T; ++e) {
          const uint32_t d = ldc(diag_small + e);
#pragma unroll
          for (int k = 0; k < L; ++k) x[e][k] = sigma[k] + d * x[e][k];
        }
      } else {
#pragma unroll
        for (int e = 0; e < T; ++e) {
          mont_mul_const(x[e], x[e], diag_mont + e * L, m);
#pragma unroll
          for (int k = 0; k < L; ++k) x[e][k] += sigma[k];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    carry_pass(x[e]);
    fold(x[e], rho, fold_exit);
    mont_mul_const(x[e], x[e], rho, m);  // rho = R mod p is the Montgomery form of 1
  }
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_p2(const int32_t* in, int32_t* out, long long B, int full_rounds,
              int partial_rounds, int n_runs, int small_diag, const int* folds,
              const int32_t* consts, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  poseidon2_kernel<T, L><<<blocks, kThreads, 0, stream>>>(
      in, out, B, full_rounds, partial_rounds, n_runs, small_diag, folds[0], folds[1],
      folds[2], folds[3], folds[4], consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L) has no instantiation.  ``folds`` (host memory) holds the
// five fold counts of ops/bounds.py FOLD_SITES.  Instantiations must match
// INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_poseidon2(const int32_t* in, int32_t* out, long long B, int t, int L,
                                int full_rounds, int partial_rounds, int n_runs,
                                int small_diag, const int* folds, const int32_t* consts,
                                unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 3 && L == 11)
    return sponge::launch_p2<3, 11>(in, out, B, full_rounds, partial_rounds, n_runs,
                                    small_diag, folds, consts, n0inv, s);
  if (t == 16 && L == 2)
    return sponge::launch_p2<16, 2>(in, out, B, full_rounds, partial_rounds, n_runs,
                                    small_diag, folds, consts, n0inv, s);
  if (t == 8 && L == 2)
    return sponge::launch_p2<8, 2>(in, out, B, full_rounds, partial_rounds, n_runs,
                                   small_diag, folds, consts, n0inv, s);
  if (t == 3 && L == 2)
    return sponge::launch_p2<3, 2>(in, out, B, full_rounds, partial_rounds, n_runs,
                                   small_diag, folds, consts, n0inv, s);
  return -1;
}
