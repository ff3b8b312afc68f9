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
// Two bodies run it, chosen by the field (ops/poseidon_opt.py body): this
// file's limb body at every field but Goldilocks, and at Goldilocks the
// two-word body of poseidon_opt_words.cu (an element one 64-bit word in
// plain form: a product is 4 widening products and no REDC, against 2 L^2
// = 18 and a REDC pass on three limbs).  Both are instantiations of
// sponge::poseidon_opt_kernel, the limb body's template over (t, L) and the
// two-word body's over t, with the same rate I/O (poseidon_opt.cuh RateIO),
// so callers and profiles see one kernel 1.  Everything below is the limb
// body.
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
// The wide states (mont.cuh kWideState: the ~255-bit fields at t = 4..9, 44
// to 99 words a lane) do not fit that lockstep schedule's live set in a
// thread's 255 registers: pow_sqr copies all t elements, mat_apply holds y
// beside x, sparse_linear holds t sets of 64-bit columns (198 registers at
// (9, 11) before x).  There the S-boxes run one element at a time
// (pow_sqr1), the MDS and D rows in a rolled loop (mds_apply) and the
// sparse round one element at a time (sparse_linear_wide): the same products
// and carries in another order, so the words, and ops/bounds.py's replay,
// stay the same.  Their launch bound asks for no blocks per SM (t = 3 keeps
// 4); at (9, 11) with alpha = 5 the staged constants take 97 KB of shared
// memory, so two blocks fit on an SM.
//
// Constant buffer layout (int32, limb axis last; poseidon/config.py
// constant_layout): p (L) | ark (R, t, L) | mds (t, t, L) |
// chat (R_P-1, t, L) | row0 (R_P-1, t, L) | col0 (R_P-1, t-1, L) | D (t, t, L).
//
// The sponge's rate I/O happens at the kernel's edges (RateIO), so a sponge
// step (absorb, permute, squeeze) is one launch: the absorbed rows are added
// into the state as it is loaded, and only the rows the caller keeps are
// stored.  Without it a step cost a dozen small PyTorch kernels around this
// one (an int64 add with its carry pass and conditional subtraction, casts,
// a cat that rebuilt the whole state, the squeeze's copy): 11% of a
// BLS12-381 Merkle commitment's device time and 29% of a Goldilocks row
// commitment's (PERF.md).  The rows are canonical and so is the state, so a
// sum needs one conditional subtraction (mont_add's arithmetic) and the
// permutation's input stays canonical.  The I/O is read from kernel
// parameters at run time, so there is one instantiation per (t, L) still.

#include "mont.cuh"
#include "poseidon_opt.cuh"

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

// sparse_linear at a wide state (mont.cuh kWideState): the row0 dot into
// its own element (mont_row: the same columns and REDC steps as
// sparse_linear's acc[0]), then x_i = x_i + col_i * x0 one element at a
// time from the old x0, x_i added to the columns after the last REDC step
// as there; x0 takes the dot last.  One element's columns are live, not t.
template <int T, int L>
__device__ __forceinline__ void sparse_linear_wide(uint32_t (&x)[T][L], const int32_t* __restrict__ row,
                                                   const int32_t* __restrict__ col, const Modulus<L>& m) {
  uint32_t x0[L];
  mont_row<T, L, FromShared>(x0, x, row, m);
#pragma unroll
  for (int e = 1; e < T; ++e) {
    uint64_t acc[L];
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t c = FromShared::load(col + (e - 1) * L + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(x[0][k]) * c;
      redc_step(acc, m);
    }
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += x[e][k];
    carry_out(x[e], acc);
  }
#pragma unroll
  for (int k = 0; k < L; ++k) x[0][k] = x0[k];
}

template <int T, int L>
__device__ __forceinline__ void add_round_constants(uint32_t (&x)[T][L], const int32_t* __restrict__ c) {
#pragma unroll
  for (int e = 0; e < T; ++e) add_const<FromShared>(x[e], c + e * L);
}

// Blocks per SM the launch bound asks for: 4 at t = 3, where the main path
// (3, 11) was tuned to 128 registers; none at the wider states, whose state
// alone takes 24 to 99 registers.
template <int T>
constexpr int kOptMinBlocks = T == 3 ? 4 : 1;

// Load the state (or zeros) and add the rate rows into it: each added row
// is canonical, so x + row < 2p, and one conditional subtraction leaves it
// canonical.  The branches are uniform across the grid.
template <int T, int L>
__device__ __forceinline__ void load_absorb(uint32_t (&x)[T][L], const int32_t* __restrict__ in, long long B,
                                            long long b, const RateIO io, const Modulus<L>& m) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
#pragma unroll
    for (int k = 0; k < L; ++k) x[e][k] = io.fresh ? 0u : static_cast<uint32_t>(in[(e * L + k) * B + b]);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = e - io.lo - v * io.k;
      if (io.rows[v] == nullptr || r < 0 || r >= io.k) continue;
      const int32_t* __restrict__ src = io.rows[v] + r * io.stride[v][0] + b * io.stride[v][2];
      uint32_t y[L];
#pragma unroll
      for (int k = 0; k < L; ++k) y[k] = static_cast<uint32_t>(src[k * io.stride[v][1]]);
      add_lazy(x[e], y);
      reduce_once(x[e], m);
    }
  }
}

// store_state for rows [lo, hi) of the state alone, into an (hi - lo, L, B)
// plane.
template <int T, int L>
__device__ __forceinline__ void store_rows(int32_t* __restrict__ out, uint32_t (&x)[T][L], long long B,
                                           long long b, int lo, int hi, const Modulus<L>& m) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (e < lo || e >= hi) continue;
    reduce_once(x[e], m);
#pragma unroll
    for (int k = 0; k < L; ++k) out[((e - lo) * L + k) * B + b] = static_cast<int32_t>(x[e][k]);
  }
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads, kOptMinBlocks<T>)
    poseidon_opt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                        uint32_t alpha, int full_rounds, int partial_rounds,
                        const int32_t* __restrict__ consts, int words, uint32_t n0inv, const RateIO io) {
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
  load_absorb<T, L>(x, in, B, b, io, m);
  // Stage s = 0..R_F: the linear layer of the stage before (D after the
  // partial phase, the MDS after a full round), then full round s (s < half)
  // or s + R_P - 1 (s > half), or at s = half the partial phase; stage
  // R_F + 1 is the last full round's MDS alone.
#pragma unroll 1
  for (int s = 0;; ++s) {
    if (s > 0) mds_apply<T, L, FromShared>(x, s == half + 1 ? dense : mds, m);
    if (s > full_rounds) break;
    if (s != half) {
      add_round_constants<T, L>(x, ark + (s < half ? s : s + partial_rounds - 1) * T * L);
      if constexpr (kWideState<T, L>) {
#pragma unroll
        for (int e = 0; e < T; ++e) pow_sqr1<L>(x[e], alpha, m);
      } else {
        pow_sqr<T, L>(x, alpha, m);
      }
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
      if constexpr (kWideState<T, L>)
        sparse_linear_wide<T, L>(x, row0 + r * T * L, col0 + r * (T - 1) * L, m);
      else
        sparse_linear<T, L>(x, row0 + r * T * L, col0 + r * (T - 1) * L, m);
    }
  }
  store_rows<T, L>(out, x, B, b, io.out_lo, io.out_hi, m);
}

template <int T, int L>
int launch_opt(const int32_t* in, int32_t* out, long long B, int alpha, int full_rounds,
               int partial_rounds, const int32_t* consts, unsigned n0inv, const RateIO& io, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  // p | ark | mds | chat | row0 | col0 | D
  const int words = L + ((full_rounds + partial_rounds) * T + 2 * T * T + (partial_rounds - 1) * (3 * T - 1)) * L;
  const size_t bytes = static_cast<size_t>(words) * sizeof(int32_t);
  if (const int err = allow_dynamic_shared(poseidon_opt_kernel<T, L>, bytes)) return err;
  poseidon_opt_kernel<T, L><<<blocks, kThreads, bytes, stream>>>(
      in, out, B, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, words, n0inv, io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sponge

// Plain C entry point (ctypes), the contract of sponge_poseidon_dense: the
// body (0: this file's limb body, reading ``consts``, kernel_constants; 2:
// the two-word body, reading ``words``, ops/poseidon_opt.py word_constants,
// of ``n_words`` int32), then the rate I/O (sponge::RateIO): the two row
// views (null: absent) with their element strides (row, limb, lane), the
// rows per view, the state row of the first, fresh (``in`` may be null),
// and the stored rows [out_lo, out_hi) (``out`` is (out_hi - out_lo, L,
// B)).  The limb body's PAIR(t, L) lines (and the two-word body's GL lines
// in poseidon_opt_words.cu) must match ops/poseidon_opt.py BODIES.
extern "C" int sponge_poseidon_opt(const int32_t* in, int32_t* out, long long B, int t, int L,
                                   int alpha, int full_rounds, int partial_rounds,
                                   const int32_t* consts, unsigned n0inv, int body, const int32_t* words,
                                   int n_words, const int32_t* rows0, const int32_t* rows1, int k,
                                   long long row0_stride, long long limb0_stride, long long lane0_stride,
                                   long long row1_stride, long long limb1_stride, long long lane1_stride, int lo,
                                   int fresh, int out_lo, int out_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partial_rounds < 2) return -1;
  if (k < 0 || lo < 0 || lo + (rows1 ? 2 : 1) * k > t || out_lo < 0 || out_lo >= out_hi || out_hi > t) return -1;
  const sponge::RateIO io{{rows0, rows1},
                          {{row0_stride, limb0_stride, lane0_stride}, {row1_stride, limb1_stride, lane1_stride}},
                          k, lo, fresh, out_lo, out_hi};
  if (body == 2)
    return sponge::launch_opt_words(in, out, B, t, L, alpha, full_rounds, partial_rounds, words, n_words, io, s);
  if (body != 0) return -1;
#define PAIR(T_, L_)                                                                              \
  if (t == T_ && L == L_)                                                                         \
    return sponge::launch_opt<T_, L_>(in, out, B, alpha, full_rounds, partial_rounds, consts, n0inv, io, s);
  PAIR(3, 11)
  PAIR(4, 11)
  PAIR(5, 11)
  PAIR(6, 11)
  PAIR(7, 11)
  PAIR(8, 11)
  PAIR(9, 11)
  PAIR(16, 2)
  PAIR(3, 2)
#undef PAIR
  return -1;
}
