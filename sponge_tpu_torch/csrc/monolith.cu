// Kernel 4: the Monolith permutation over a (t, L, B) int32 plane.
//
// Replaces sponge_tpu/ops/pallas_monolith.py (monolith_kernel_fn, bodies
// _monolith_kernel and _monolith_kernel_mersenne).  Schedule (ePrint
// 2023/1025): Concrete, then per round
//     Bars     on x_0..x_{u-1}: chi-like S-boxes on the canonical bit chunks;
//     Bricks   x_i += x_{i-1}^2 for i = t-1 down to 1 (squares of the values
//              before the update);
//     Concrete x <- M x, then x += rc[round] (the last row is zero);
// then a canonical output plane.
//
// Two bodies; ops/bounds.py check_monolith_bounds picks one per config and
// derives its fold counts by replaying it on value and word bounds:
//
// * Generic (Goldilocks, KoalaBear, BabyBear): Montgomery limbs as every
//   other kernel.  Bars take the REDC of the element alone (out of
//   Montgomery form, value <= p: word for word a product by plain 1), the
//   conditional subtraction (exact canonical bits), chi on every chunk of a
//   limb at once (no chunk straddles two 24-bit limbs: chunks never cross a
//   multiple of 8), and a product by R^2 mod p (back, below 2p).  Bricks
//   square with mont_sqr and rho-fold the square and the sum.  The circulant
//   Concrete (a circulant of positive integers below 2^24: every shipped
//   default) multiplies the plain entry into each 32-bit limb word and sums
//   the t terms in 64-bit columns: Goldilocks t = 12 has entries up to 2^16
//   and a row sum of 70,967, so a 24-bit limb times an entry passes 2^32
//   and the 32-bit small_mat_apply of kernel 3 would overflow; the high part
//   (value / R, below 2^17 R) is folded back through rho = R mod p in the
//   same columns (fold_cols).  The dense Concrete (a Cauchy matrix) is one
//   lazily summed Montgomery row per element (mat_apply).  Exit: a product
//   by the Montgomery form of 1 and the conditional subtraction.
// * Mersenne (p = 2^n - 1, n <= 32: Mersenne31): R mod p = 2^s (s = 17 at
//   L = 2), so the Montgomery form is the canonical value rotated left by s
//   within n bits and one canonical value fits one 32-bit word.  The body
//   rotates right by s on entry and left on exit and works on canonical
//   words in between: no Montgomery reduction anywhere.  A square, a
//   Concrete row or a sum is formed in 64 bits and reduced by 2^n = 1 folds
//   (v -> (v >> n) + (v & p)) below 2p, then by one conditional subtraction.
//   n and s follow from the chunk pattern at compile time (the chunks cover
//   the n bits).  The round constants and the matrix are plain in the
//   constant buffer.
//
// What bounds it on the H100: integer multiply-add issue (the Concrete's t^2
// L scalings and the squares), with state traffic within 4x of it.  Design:
// one thread per lane, state in registers, one rolled round loop; the
// Concrete rows are unrolled (t^2 L straight-line 64-bit multiply-adds).
// What the multiplies leave of the issue slots goes to nothing else where it
// can be helped: each block stages the constant buffer in shared memory, as
// kernel 1 does (mont.cuh FromShared), and the circulant's first row, rho,
// R^2 and the modulus sit in registers from before the round loop (the
// circulant Concrete indexes the row statically, so it loads nothing), a Bar applies chi to all the chunks of a
// word with shifts and masks fixed at compile time by the field's chunk
// pattern (the template argument W), and the plan's fold counts are a
// template argument too (FOLDS, packed by ``plan_code``), so every fold
// loop unrolls to straight-line code with no branch: the plans of the
// shipped configs are instantiated, and any other plan runs the
// instantiation that reads its counts at run time (kRuntimeFolds, each
// fold loop unrolled to kMaxFolds behind a warp-uniform guard).
//
// Constant buffer layout (int32, limb axis last; monolith/config.py
// constant_layout): p (L) | rho = R mod p (L) | plain 1 (L) | R^2 mod p (L) |
// Bar chunk widths (n_chunks) | rc (rounds, t, L) | M (t, t, L).

#include "mont.cuh"

namespace sponge {

// Fold loops unroll this far; ops/monolith.py refuses a plan that needs more.
constexpr int kMaxFolds = 4;

// A plan's fold counts (ops/bounds.py MONOLITH_SITES: squares, sums,
// Concrete, round constants), 2 bits each; -1 where one passes 3.
__host__ __device__ constexpr int plan_code(int f_sq, int f_add, int f_conc, int f_rc) {
  return (f_sq | f_add | f_conc | f_rc) > 3 ? -1 : f_sq | f_add << 2 | f_conc << 4 | f_rc << 6;
}
constexpr int kRuntimeFolds = -1;  // FOLDS of the instantiation that takes any plan

// Fold count ``site`` of the plan: the template's where FOLDS holds a plan,
// else the kernel argument.
template <int FOLDS>
__device__ __forceinline__ int folds_at(int site, int runtime) {
  if constexpr (FOLDS == kRuntimeFolds) {
    return runtime;
  } else {
    return (FOLDS >> (2 * site)) & 3;
  }
}

// ---- Bars: the chi-like S-box on every chunk of a word at once ----
//
// A field's Bar chunk widths (monolith/config.py bar_chunks) are the 4-bit
// digits of W, the lowest chunk first (ops/monolith.py chunk_pattern).
constexpr uint64_t kChunksGoldilocks = 0x88888888ull;  // 8 x 8
constexpr uint64_t kChunks31 = 0x7888ull;              // Mersenne31, KoalaBear: 8,8,8,7
constexpr uint64_t kChunksBabyBear = 0x43888ull;       // 8,8,8,3,4

__host__ __device__ constexpr int chunk_width(uint64_t W, int i) { return static_cast<int>((W >> (4 * i)) & 15); }

__host__ __device__ constexpr int chunk_count(uint64_t W) {
  int n = 0;
  while (n < 16 && chunk_width(W, n) != 0) ++n;
  return n;
}

// The field's bit length n: its chunks cover the value.
__host__ __device__ constexpr int chunk_total(uint64_t W) {
  int n = 0;
  for (int i = 0; i < chunk_count(W); ++i) n += chunk_width(W, i);
  return n;
}

// Words of the constant buffer: p, rho, 1, R^2, the chunk widths, rc, M.
template <int T, int L, uint64_t W>
__host__ __device__ constexpr int constant_words(int rounds) {
  return 4 * L + chunk_count(W) + (rounds * T + T * T) * L;
}

// Bits [o + a, o + min(b, k)) of every chunk (offset o) of width k (k = 0:
// any width) that lies inside bits [lo, lo + n), relative to lo.
__host__ __device__ constexpr uint32_t chunk_mask(uint64_t W, int lo, int n, int k, int a, int b) {
  uint32_t mask = 0;
  int o = 0;
  for (int i = 0; i < chunk_count(W); ++i) {
    const int w = chunk_width(W, i);
    if ((k == 0 || w == k) && o >= lo && o + w <= lo + n)
      for (int j = a; j < b && j < w; ++j) mask |= 1u << (o - lo + j);
    o += w;
  }
  return mask;
}

__host__ __device__ constexpr uint32_t odd_chunk_mask(uint64_t W, int lo, int n) {
  uint32_t mask = 0;
  for (int k = 1; k < 16; k += 2) mask |= chunk_mask(W, lo, n, k, 0, k);
  return mask;
}

// The chunks of width K rotated left by R mod K within themselves.
template <uint64_t W, int LO, int N, int R, int K>
__device__ __forceinline__ uint32_t rot_width(uint32_t v) {
  constexpr int r = R % K;
  constexpr uint32_t keep = chunk_mask(W, LO, N, K, r, K), wrap = chunk_mask(W, LO, N, K, 0, r);
  uint32_t out = 0;
  if constexpr (keep != 0) out |= (v << r) & keep;
  if constexpr (wrap != 0) out |= (v >> (K - r)) & wrap;
  return out;
}

// Every chunk of the word rotated left by R within itself (bar_chunks never
// gives a chunk wider than 8 bits).
template <uint64_t W, int LO, int N, int R>
__device__ __forceinline__ uint32_t rot_chunks(uint32_t v) {
  return rot_width<W, LO, N, R, 1>(v) | rot_width<W, LO, N, R, 2>(v) | rot_width<W, LO, N, R, 3>(v) |
         rot_width<W, LO, N, R, 4>(v) | rot_width<W, LO, N, R, 5>(v) | rot_width<W, LO, N, R, 6>(v) |
         rot_width<W, LO, N, R, 7>(v) | rot_width<W, LO, N, R, 8>(v);
}

// chunk_sbox (monolith/config.py) on every chunk of the word that holds bits
// [LO, LO + N) of a canonical value: z = y ^ (rot1(~y) & rot2(y) & rot3(y))
// for even widths, whose rot3 term an odd chunk replaces by ones (the
// 2-rotation form), then rot1(z).
template <uint64_t W, int LO, int N>
__device__ __forceinline__ uint32_t chi_word(uint32_t y) {
  constexpr uint32_t all = chunk_mask(W, LO, N, 0, 0, 32), odd = odd_chunk_mask(W, LO, N);
  const uint32_t z = y ^ (rot_chunks<W, LO, N, 1>(y ^ all) & rot_chunks<W, LO, N, 2>(y) &
                          (rot_chunks<W, LO, N, 3>(y) | odd));
  return rot_chunks<W, LO, N, 1>(z);
}

// Bar of canonical plain limbs, limb K onward: limb k holds bits
// [24 k, 24 k + 24) and every chunk starting there.
template <uint64_t W, int K, int L>
__device__ __forceinline__ void bar_limbs(uint32_t (&x)[L]) {
  x[K] = chi_word<W, kLimbBits * K, kLimbBits>(x[K]);
  if constexpr (K + 1 < L) bar_limbs<W, K + 1, L>(x);
}

// ---- the generic body's arithmetic, constants in registers ----

// x / R (mod p): the REDC of x alone, word for word mont_mul by plain 1
// (whose limbs 1..L-1 add nothing), without the zero products.
template <int L>
__device__ __forceinline__ void mont_redc(uint32_t (&x)[L], const Modulus<L>& m) {
  uint64_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = x[k];
#pragma unroll
  for (int i = 0; i < L; ++i) redc_step(acc, m);
  carry_out(x, acc);
}

// mont.cuh fold with rho in registers: n <= kMaxFolds top-carry rho-folds.
template <int L>
__device__ __forceinline__ void fold_regs(uint32_t (&x)[L], const uint32_t (&rho)[L], int n) {
#pragma unroll
  for (int f = 0; f < kMaxFolds; ++f) {
    if (f < n) {
      const uint32_t c = x[L - 1] >> kLimbBits;
      x[L - 1] &= kLimbMask;
      uint32_t y[L];
#pragma unroll
      for (int k = 0; k < L; ++k) y[k] = c * rho[k];
      add_lazy(x, y);
    }
  }
}

// 64-bit columns -> carried words, with n folds of the part at or above R:
// carry, then value = lo + H R = lo + H rho (mod p), H * rho_k added in the
// same columns.  ops/bounds.py bounds H below 2^39 and the last top word
// below 2^32.
template <int L>
__device__ __forceinline__ void fold_cols(uint32_t (&out)[L], uint64_t (&acc)[L],
                                          const uint32_t (&rho)[L], int n) {
#pragma unroll
  for (int f = 0; f < kMaxFolds; ++f) {
    if (f < n) {
      uint64_t c = 0;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const uint64_t v = acc[k] + c;
        acc[k] = v & kLimbMask;
        c = v >> kLimbBits;
      }
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += c * rho[k];
    }
  }
  carry_out(out, acc);
}

// The Concrete of the generic body: y_i = sum_j row[(j - i) mod t] x_j for
// the circulant (row: its plain first row), else the dense Montgomery rows
// of ``mat``, read from global memory (read from the staged copy, the
// t = 12 and 16 instantiations spilled over 1 KB a thread).
template <int T, int L, bool CIRC>
__device__ __forceinline__ void concrete(uint32_t (&x)[T][L], const uint32_t (&row)[CIRC ? T : 1],
                                         const int32_t* __restrict__ mat, const uint32_t (&rho)[L],
                                         int folds, const Modulus<L>& m) {
  if constexpr (CIRC) {
    uint32_t y[T][L];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint64_t acc[L];
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] = 0;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t c = row[(j - i + T) % T];
#pragma unroll
        for (int k = 0; k < L; ++k) acc[k] += static_cast<uint64_t>(c) * x[j][k];
      }
      fold_cols(y[i], acc, rho, folds);
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int k = 0; k < L; ++k) x[i][k] = y[i][k];
  } else {
    mat_apply<T, L>(x, mat, m);
#pragma unroll
    for (int i = 0; i < T; ++i) fold_regs(x[i], rho, folds);
  }
}

template <int T, int L, uint64_t W, bool CIRC, int FOLDS>
__global__ void __launch_bounds__(kThreads)
    monolith_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                    int rounds, int bars, int rt_sq, int rt_add, int rt_conc, int rt_rc,
                    const int32_t* __restrict__ consts, uint32_t n0inv) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, constant_words<T, L, W>(rounds));
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int f_sq = folds_at<FOLDS>(0, rt_sq), f_add = folds_at<FOLDS>(1, rt_add);
  const int f_conc = folds_at<FOLDS>(2, rt_conc), f_rc = folds_at<FOLDS>(3, rt_rc);
  Modulus<L> m;
  load_modulus<FromShared>(m, c, n0inv);
  const int32_t* rc = c + 4 * L + chunk_count(W);
  const int32_t* mat = rc + rounds * T * L;  // the staged copy (circulant row)
  const int32_t* gmat = consts + (mat - c);  // the global one (dense rows)
  uint32_t rho[L], r2[L], row[CIRC ? T : 1];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    rho[k] = FromShared::load(c + L + k);
    r2[k] = FromShared::load(c + 3 * L + k);
  }
  if constexpr (CIRC) {
#pragma unroll
    for (int j = 0; j < T; ++j) row[j] = FromShared::load(mat + j * L);  // a plain entry is its own low limb
  }

  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  concrete<T, L, CIRC>(x, row, gmat, rho, f_conc, m);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e) {
      if (e < bars) {
        mont_redc(x[e], m);  // out of Montgomery form: value <= p
        reduce_once(x[e], m);
        bar_limbs<W, 0>(x[e]);
        mont_mul(x[e], x[e], r2, m);
      }
    }
#pragma unroll
    for (int i = T - 1; i >= 1; --i) {  // x_{i-1} is still the pre-update value
      uint32_t sq[L];
      mont_sqr(sq, x[i - 1], m);
      fold_regs(sq, rho, f_sq);
      add_lazy(x[i], sq);
      fold_regs(x[i], rho, f_add);
    }
    concrete<T, L, CIRC>(x, row, gmat, rho, f_conc, m);
#pragma unroll
    for (int e = 0; e < T; ++e) {
      add_const<FromShared>(x[e], rc + (r * T + e) * L);
      fold_regs(x[e], rho, f_rc);
    }
  }
#pragma unroll
  for (int e = 0; e < T; ++e) mont_mul(x[e], x[e], rho, m);  // rho is the Montgomery form of 1
  store_state<T, L>(out, x, B, b, m);
}

// ---- the Mersenne body: one canonical word per element ----

template <int L, typename Src = FromShared>
__device__ __forceinline__ uint32_t ld_word(const int32_t* __restrict__ c) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) v |= Src::load(c + k) << (kLimbBits * k);
  return v;
}


// v < 2^64 -> canonical modulo p = 2^N - 1, by ``folds`` <= kMaxFolds
// 2^N = 1 folds (then below 2p) and one conditional subtraction.
template <int N>
__device__ __forceinline__ uint32_t mersenne_reduce(uint64_t v, int folds) {
  constexpr uint64_t p = (1ull << N) - 1;
#pragma unroll
  for (int f = 0; f < kMaxFolds; ++f)
    if (f < folds) v = (v >> N) + (v & p);
  const uint32_t w = static_cast<uint32_t>(v);
  return w >= p ? w - static_cast<uint32_t>(p) : w;
}

// Rotate left by S within N bits (v < 2^N).
template <int N, int S>
__device__ __forceinline__ uint32_t rotl_bits(uint32_t v) {
  const uint64_t w = v;
  return static_cast<uint32_t>(((w << S) | (w >> (N - S))) & ((1ull << N) - 1));
}

// The Concrete of the Mersenne body: the circulant from its first row in
// registers, else the dense matrix's entries read as words from global
// memory (as the generic body's dense rows).
template <int T, int L, int N, bool CIRC>
__device__ __forceinline__ void concrete_words(uint32_t (&x)[T], const uint32_t (&row)[CIRC ? T : 1],
                                               const int32_t* __restrict__ mat, int folds) {
  uint32_t y[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      uint32_t c;
      if constexpr (CIRC) {
        c = row[(j - i + T) % T];
      } else {
        c = ld_word<L, FromGlobal>(mat + (i * T + j) * L);
      }
      acc += static_cast<uint64_t>(c) * x[j];
    }
    y[i] = mersenne_reduce<N>(acc, folds);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = y[i];
}

template <int T, int L, uint64_t W, bool CIRC, int FOLDS>
__global__ void __launch_bounds__(kThreads)
    monolith_mersenne_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                             int rounds, int bars, int rt_sq, int rt_add, int rt_conc, int rt_rc,
                             const int32_t* __restrict__ consts) {
  extern __shared__ int32_t c[];
  stage_constants(c, consts, constant_words<T, L, W>(rounds));
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int f_sq = folds_at<FOLDS>(0, rt_sq), f_add = folds_at<FOLDS>(1, rt_add);
  const int f_conc = folds_at<FOLDS>(2, rt_conc), f_rc = folds_at<FOLDS>(3, rt_rc);
  constexpr int n = chunk_total(W), s = kLimbBits * L % n;  // R mod p = 2^s
  const int32_t* rc = c + 4 * L + chunk_count(W);
  const int32_t* mat = rc + rounds * T * L;
  const int32_t* gmat = consts + (mat - c);
  uint32_t row[CIRC ? T : 1];
  if constexpr (CIRC) {
#pragma unroll
    for (int j = 0; j < T; ++j) row[j] = ld_word<L>(mat + j * L);
  }

  uint32_t x[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) v |= static_cast<uint32_t>(in[(e * L + k) * B + b]) << (kLimbBits * k);
    x[e] = rotl_bits<n, n - s>(v);  // Montgomery form -> canonical: rotate right by s
  }
  concrete_words<T, L, n, CIRC>(x, row, gmat, f_conc);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < T; ++e)
      if (e < bars) x[e] = chi_word<W, 0, 32>(x[e]);
#pragma unroll
    for (int i = T - 1; i >= 1; --i) {
      const uint32_t sq = mersenne_reduce<n>(static_cast<uint64_t>(x[i - 1]) * x[i - 1], f_sq);
      x[i] = mersenne_reduce<n>(static_cast<uint64_t>(x[i]) + sq, f_add);
    }
    concrete_words<T, L, n, CIRC>(x, row, gmat, f_conc);
#pragma unroll
    for (int e = 0; e < T; ++e)
      x[e] = mersenne_reduce<n>(static_cast<uint64_t>(x[e]) + ld_word<L>(rc + (r * T + e) * L), f_rc);
  }
#pragma unroll
  for (int e = 0; e < T; ++e) {
    const uint32_t v = rotl_bits<n, s>(x[e]);  // canonical -> Montgomery form
#pragma unroll
    for (int k = 0; k < L; ++k)
      out[(e * L + k) * B + b] = static_cast<int32_t>(k < L - 1 ? (v >> (kLimbBits * k)) & kLimbMask
                                                               : v >> (kLimbBits * k));
  }
}

struct Launch {
  const int32_t* in;
  int32_t* out;
  long long B;
  int rounds, bars;
  const int* plan;  // fold counts, n, s
  const int32_t* consts;
  unsigned n0inv;
  cudaStream_t stream;
};

template <int T, int L, uint64_t W, bool CIRC, bool MERSENNE, int FOLDS>
int launch_kernel(const Launch& a) {
  const unsigned blocks = static_cast<unsigned>((a.B + kThreads - 1) / kThreads);
  const size_t bytes = sizeof(int32_t) * constant_words<T, L, W>(a.rounds);
  const int* f = a.plan;
  if constexpr (MERSENNE) {
    constexpr int n = chunk_total(W);
    if (f[4] != n || f[5] != kLimbBits * L % n) return -1;  // the plan's bit length and shift
    auto kernel = monolith_mersenne_kernel<T, L, W, CIRC, FOLDS>;
    if (const int err = allow_dynamic_shared(kernel, bytes)) return err;
    kernel<<<blocks, kThreads, bytes, a.stream>>>(a.in, a.out, a.B, a.rounds, a.bars, f[0], f[1], f[2], f[3],
                                                  a.consts);
  } else {
    auto kernel = monolith_kernel<T, L, W, CIRC, FOLDS>;
    if (const int err = allow_dynamic_shared(kernel, bytes)) return err;
    kernel<<<blocks, kThreads, bytes, a.stream>>>(a.in, a.out, a.B, a.rounds, a.bars, f[0], f[1], f[2], f[3],
                                                  a.consts, a.n0inv);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the plan's code among PLANS, else the run-time one.
template <int T, int L, uint64_t W, bool CIRC, bool MERSENNE, int... PLANS>
int launch_plan(const Launch& a) {
  const int code = plan_code(a.plan[0], a.plan[1], a.plan[2], a.plan[3]);
  int rc = 1;
  bool found = false;
  ((!found && code == PLANS ? (found = true, rc = launch_kernel<T, L, W, CIRC, MERSENNE, PLANS>(a)) : 0), ...);
  return found ? rc : launch_kernel<T, L, W, CIRC, MERSENNE, kRuntimeFolds>(a);
}

// The plans of the shipped configs (ops/bounds.py check_monolith_bounds):
// generic circulant Goldilocks t = 12 (0, 0, 2, 1), Goldilocks t = 8 and the
// 31-bit fields at t = 16 (0, 0, 1, 1); generic dense (the t = 4 Cauchy
// configs) (0, 0, 0, 0); Mersenne31 circulant (1, 0, 1, 0), dense
// (1, 0, 2, 0).
template <int T, int L, uint64_t W>
int launch_pattern(const Launch& a, int mersenne, int circulant) {
  if (mersenne) {
    if constexpr (W == kChunks31) {  // Mersenne31: n = 31 bits in two 24-bit limbs
      if (circulant) return launch_plan<T, L, W, true, true, plan_code(1, 0, 1, 0)>(a);
      return launch_plan<T, L, W, false, true, plan_code(1, 0, 2, 0)>(a);
    } else {
      return -1;
    }
  }
  if (!circulant) return launch_plan<T, L, W, false, false, plan_code(0, 0, 0, 0)>(a);
  if constexpr (L == 3) {
    return launch_plan<T, L, W, true, false, plan_code(0, 0, 2, 1), plan_code(0, 0, 1, 1)>(a);
  } else {
    return launch_plan<T, L, W, true, false, plan_code(0, 0, 1, 1)>(a);
  }
}

template <int T, int L>
int launch_monolith(const Launch& a, unsigned long long chunks, int mersenne, int circulant) {
  for (int i = 0; i < 4; ++i)
    if (a.plan[i] < 0 || a.plan[i] > kMaxFolds) return -1;
  if constexpr (L == 3) {
    if (chunks == kChunksGoldilocks) return launch_pattern<T, L, kChunksGoldilocks>(a, mersenne, circulant);
  } else {
    if (chunks == kChunks31) return launch_pattern<T, L, kChunks31>(a, mersenne, circulant);
    if (chunks == kChunksBabyBear) return launch_pattern<T, L, kChunksBabyBear>(a, mersenne, circulant);
  }
  return -1;
}

}  // namespace sponge

// Plain C entry point (ctypes): returns cudaGetLastError() after the launch,
// or -1 when (t, L), the Bar chunk pattern (ops/monolith.py
// KERNEL_CHUNK_PATTERNS) or a fold count beyond kMaxFolds has no
// instantiation; a plan other than the shipped ones runs the run-time
// fold-count instantiation.  ``plan`` (host memory) holds the fold counts of
// ops/bounds.py MONOLITH_SITES, the bit length n and the Mersenne shift s.
// Instantiations must match INSTANTIATIONS in sponge_tpu_torch/ops/_build.py.
extern "C" int sponge_monolith(const int32_t* in, int32_t* out, long long B, int t, int L,
                               int rounds, int bars, unsigned long long chunks, int mersenne,
                               int circulant, const int* plan, const int32_t* consts,
                               unsigned n0inv, void* stream) {
  const sponge::Launch a{in, out, B, rounds, bars, plan, consts, n0inv, static_cast<cudaStream_t>(stream)};
  if (t == 12 && L == 3) return sponge::launch_monolith<12, 3>(a, chunks, mersenne, circulant);
  if (t == 8 && L == 3) return sponge::launch_monolith<8, 3>(a, chunks, mersenne, circulant);
  if (t == 16 && L == 2) return sponge::launch_monolith<16, 2>(a, chunks, mersenne, circulant);
  if (t == 4 && L == 2) return sponge::launch_monolith<4, 2>(a, chunks, mersenne, circulant);
  return -1;
}
