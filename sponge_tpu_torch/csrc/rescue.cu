// Kernel 5: the Rescue-Prime permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_rescue.py (rescue_permute_fn, body
// _rescue_kernel).  2N half-rounds, alternating the exponent:
//     x <- x^alpha (or x^(1/alpha)) on every element;  x <- MDS x;  x += rc[h]
// then the exit: one Montgomery product by 1 (values below 2p) and a
// conditional subtraction, so the output is canonical.
//
// Both exponents run through one sliding-window chain (mont.cuh
// pow_window) with squarings by mont_sqr: the schedules
// (ops/montgomery.py window_schedule, at the windows of rescue/config.py
// windows) sit in the constant buffer and are read by loop index.  At
// BLS12-381 x^5 is the 1-bit window (2 squarings, 1 multiply) and
// x^(1/5) the 3-bit one: 252 squarings and 66 multiplies with the table,
// 63,096 limb products against the binary ladder's 253 + 129 full products
// (92,444).  The TPU kernel's 4-bit fixed window keeps its table in VMEM;
// here a table of t x L words per odd power is too much for registers, so
// x^3 .. x^(2^w - 1) sit in shared memory (396 bytes per thread at t = 3,
// L = 11, w = 3) and x in registers: the window rule keeps the 4 blocks
// per SM that the registers allow (__launch_bounds__ below).  The MDS rows are lazily accumulated dot
// products with one REDC each (mont_row).  ops/bounds.py
// check_rescue_bounds replays this schedule and proves every product input
// below R.
//
// What bounds it on the H100: widening multiply-add issue; about 14 x 2 x
// 3 x 63,800 limb products per lane at BLS12-381 for 264 bytes of state.
// Design: one thread per lane, state in registers, the chain in lockstep
// over the t elements (independent chains), one rolled loop over the
// half-rounds so the chain and the MDS are each inlined once.
//
// The wide states (mont.cuh kWideState: the ~255-bit fields at t = 4..9, 44
// to 99 words a lane) take kernel 1's wide schedule: the lockstep chain
// would hold t bases beside the state and t tables.  There the chain runs
// one element at a time in a rolled loop (element 0 raised, then shifted in
// at the top: shift_in), its table one chain (rescue/config.py windows asks
// window_for for one chain), and the MDS rows run in a rolled loop
// (mat_apply_rows).  Every element takes the same products and carries as
// in lockstep, so the words, and the replay, are the same.  The launch bound
// asks for 4 blocks per SM below kWideWords and for none at the wide states,
// whose state alone takes 44 to 99 registers.
//
// Constant buffer layout (int32, limb axis last; rescue/config.py
// constant_layout): p (L) | one = R mod p (L) | rc (2N, t, L) | mds (t, t, L) |
// alpha window schedule | inverse-alpha window schedule.

#include "mont.cuh"

namespace sponge {

// Blocks per SM the launch bound asks for: 4 (at most 128 registers a
// thread) below kWideWords, where left to itself ptxas takes more at
// (3, 11) and the SM holds 3; none at the wide states.
template <int T, int L>
constexpr int kRescueMinBlocks = kWideState<T, L> ? 1 : 4;

template <int T, int L>
__global__ void __launch_bounds__(kThreads, kRescueMinBlocks<T, L>)
    rescue_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                  int rounds, int w_alpha, int n_alpha, int w_inv, int n_inv,
                  const int32_t* __restrict__ consts, uint32_t n0inv) {
  extern __shared__ uint32_t table_base[];
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* rc = one + L;
  const int32_t* mds = rc + 2 * rounds * T * L;
  const int32_t* alpha_sched = mds + T * T * L;
  const int32_t* inv_sched = alpha_sched + n_alpha;
  uint32_t* table = table_base + threadIdx.x;

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
#pragma unroll 1
  for (int h = 0; h < 2 * rounds; ++h) {
    const bool inverse = h & 1;
    const int32_t* sched = inverse ? inv_sched : alpha_sched;
    const int n_sched = inverse ? n_inv : n_alpha, w = inverse ? w_inv : w_alpha;
    if constexpr (kWideState<T, L>) {
#pragma unroll 1
      for (int e = 0; e < T; ++e) {
        uint32_t y[1][L];
#pragma unroll
        for (int k = 0; k < L; ++k) y[0][k] = x[0][k];
        pow_window<1, L>(y, sched, n_sched, w, table, m);
        shift_in<T, L>(x, y[0]);
      }
      mat_apply_rows<T, L>(x, mds, m);
    } else {
      pow_window<T, L>(x, sched, n_sched, w, table, m);
      mat_apply<T, L>(x, mds, m);
    }
#pragma unroll
    for (int e = 0; e < T; ++e) add_const(x[e], rc + (h * T + e) * L);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) mont_mul_const(x[e], x[e], one, m);
  store_state<T, L>(out, x, B, b, m);
}

template <int T, int L>
int launch_rescue(const int32_t* in, int32_t* out, long long B, int rounds, int w_alpha,
                  int n_alpha, int w_inv, int n_inv, const int32_t* consts, unsigned n0inv,
                  cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const size_t shared = window_table_bytes(kWideState<T, L> ? 1 : T, L, w_alpha > w_inv ? w_alpha : w_inv);
  if (const int err = allow_dynamic_shared(rescue_kernel<T, L>, shared)) return err;
  rescue_kernel<T, L><<<blocks, kThreads, shared, stream>>>(in, out, B, rounds, w_alpha, n_alpha,
                                                            w_inv, n_inv, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes): returns the CUDA error of a refused shared
// memory size or cudaGetLastError() after the launch, or -1 when (t, L) has
// no instantiation.  Instantiations must match INSTANTIATIONS in
// sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_rescue(const int32_t* in, int32_t* out, long long B, int t, int L,
                             int rounds, int w_alpha, int n_alpha, int w_inv, int n_inv,
                             const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_rescue<T_, L_>(in, out, B, rounds, w_alpha, n_alpha, w_inv, n_inv, consts, \
                                         n0inv, s);
  PAIR(2, 11)
  PAIR(3, 11)
  PAIR(4, 11)
  PAIR(5, 11)
  PAIR(6, 11)
  PAIR(7, 11)
  PAIR(8, 11)
  PAIR(9, 11)
  PAIR(5, 3)
  PAIR(6, 3)
  PAIR(7, 3)
  PAIR(8, 3)
  PAIR(9, 3)
  PAIR(10, 3)
  PAIR(11, 3)
  PAIR(12, 3)
  PAIR(9, 2)
  PAIR(10, 2)
  PAIR(11, 2)
  PAIR(12, 2)
  PAIR(13, 2)
  PAIR(14, 2)
  PAIR(15, 2)
  PAIR(16, 2)
  PAIR(3, 2)
#undef PAIR
  return -1;
}
