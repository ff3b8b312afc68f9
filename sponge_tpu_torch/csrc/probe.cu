// The probe kernels: the H100 counterparts of the JAX package's bench/
// probes, which measured the TPU's vector unit.
//
// sponge_probe_chains replaces bench/latency_probe.py (main: one dependent
// chain of 64 Montgomery products against two interleaved chains),
// bench/uint32_probe.py (check_semantics, time_chains: uint32 multiply and
// shift semantics, int32 against uint32 multiply-add chains) and
// bench/vpu_roofline_probe.py (measure_peak, main: the peak integer issue
// rate under which every kernel's share is read).  Each thread runs C
// independent register chains of ``iters`` x kUnroll steps of one operation:
//     kMul   a = a * m          (mul.lo.u32: IMAD)
//     kMad   a = a * m + k      (mad.lo.u32: IMAD)
//     kAdd   a = a + m          (add.u32: IADD3)
//     kWide  a = a + x * m_u    (mad.wide.u32 into a 64-bit accumulator,
//                                the column step of every mont.cuh product;
//                                x = hi(a) at the start of each loop
//                                iteration, m_u = m + u k for unrolled step
//                                u, so no product is loop-invariant)
//     kMont  a = a * c / R      (mont.cuh mont_mul_const at L = 11, BLS12-381
//                                Fr: ``iters`` products per chain, no unroll)
// m and k are read from the constant buffer at run time and every chain's
// last value is stored, so nothing folds or dies.  kWide's step is PTX:
// written in C++, the 16 products by one x fold into one (x times the sum
// of the m_u).  ptxas issues it as IMAD.WIDE.U32 and a 64-bit IADD3 pair on
// the ALU pipe; it never takes a 64-bit register addend into the
// IMAD.WIDE.U32, in this form or in a chain a = hi(a) * m + a, which also
// spends an IMAD.X of the multiply pipe per step.  With ``clocks`` given,
// thread 0 writes its elapsed SM cycles and nanoseconds (%globaltimer):
// cycles per step at C = 1 is the dependent latency (for kWide that of the
// 64-bit accumulate, plus one product's latency per loop iteration), cycles
// per nanosecond the SM clock during the run.
//
// sponge_probe_ablation replaces bench/latency_accounting_probe.py (main,
// body ablation_kernel): kernel 1's BLS12-381 rate-2 round schedule cut to
// nested prefixes, ``mode`` 0 copy (load and store), 1 ark (every round adds
// its round constants, carried), 2 pow (also the S-boxes: t per full round,
// one per partial round); modes 1 and 2 end with one Montgomery product by 1
// and the conditional subtraction, so the output is canonical.  Kernel 1
// itself is the full row.  Values stay below 45p of R = 565p
// (ops/probe.py checks it with the kernels' bound replay).
//
// What bounds them: integer issue (chains), the same as kernel 1 (ablation).
// Constant buffers: chains m | k, or p (11) | c (11) for kMont; ablation
// p (L) | one = R mod p (L) | ark (rounds, t, L).

#include "mont.cuh"

namespace sponge {

enum ProbeOp { kMul = 0, kMad = 1, kAdd = 2, kWide = 3, kMont = 4 };
constexpr int kUnroll = 16;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm volatile("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

template <int OP, int C>
__global__ void __launch_bounds__(kThreads)
    chains_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                  int iters, const int32_t* __restrict__ consts, long long* clocks,
                  uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long c0 = clock64();
  const unsigned long long t0 = global_ns();
  if constexpr (OP == kMont) {
    Modulus<11> m;
    load_modulus(m, consts, n0inv);
    uint32_t a[C][11];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < 11; ++k) a[c][k] = static_cast<uint32_t>(in[(c * 11 + k) * B + b]);
#pragma unroll 1
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) mont_mul_const(a[c], a[c], consts + 11, m);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      reduce_once(a[c], m);
#pragma unroll
      for (int k = 0; k < 11; ++k) out[(c * 11 + k) * B + b] = static_cast<int32_t>(a[c][k]);
    }
  } else if constexpr (OP == kWide) {
    const uint32_t m = ldc(consts), k = ldc(consts + 1);
    uint32_t mul[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mul[u] = m + static_cast<uint32_t>(u) * k;
    uint64_t a[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      a[c] = static_cast<uint32_t>(in[(2 * c) * B + b]) |
             (static_cast<uint64_t>(static_cast<uint32_t>(in[(2 * c + 1) * B + b])) << 32);
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
      uint32_t x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = static_cast<uint32_t>(a[c] >> 32);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) a[c] = mad_wide(x[c], mul[u], a[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[(2 * c) * B + b] = static_cast<int32_t>(static_cast<uint32_t>(a[c]));
      out[(2 * c + 1) * B + b] = static_cast<int32_t>(static_cast<uint32_t>(a[c] >> 32));
    }
  } else {
    const uint32_t mul = ldc(consts), add = ldc(consts + 1);
    uint32_t a[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = static_cast<uint32_t>(in[c * B + b]);
#pragma unroll 1
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (OP == kMul) a[c] = a[c] * mul;
          if constexpr (OP == kMad) a[c] = a[c] * mul + add;
          if constexpr (OP == kAdd) a[c] = a[c] + mul;
        }
#pragma unroll
    for (int c = 0; c < C; ++c) out[c * B + b] = static_cast<int32_t>(a[c]);
  }
  if (clocks != nullptr && b == 0) {
    clocks[0] = clock64() - c0;
    clocks[1] = static_cast<long long>(global_ns() - t0);
  }
}

template <int OP, int C>
int launch_chains(const int32_t* in, int32_t* out, long long B, int iters, const int32_t* consts,
                  long long* clocks, unsigned n0inv, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  chains_kernel<OP, C><<<blocks, kThreads, 0, stream>>>(in, out, B, iters, consts, clocks, n0inv);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int dispatch_chains(const int32_t* in, int32_t* out, long long B, int chains, int iters,
                    const int32_t* consts, long long* clocks, unsigned n0inv, cudaStream_t s) {
  if constexpr (OP == kMont) {
    if (chains == 1) return launch_chains<OP, 1>(in, out, B, iters, consts, clocks, n0inv, s);
    if (chains == 2) return launch_chains<OP, 2>(in, out, B, iters, consts, clocks, n0inv, s);
  } else {
    if (chains == 1) return launch_chains<OP, 1>(in, out, B, iters, consts, clocks, n0inv, s);
    if (chains == 4) return launch_chains<OP, 4>(in, out, B, iters, consts, clocks, n0inv, s);
    if (chains == 8) return launch_chains<OP, 8>(in, out, B, iters, consts, clocks, n0inv, s);
    if (chains == 16) return launch_chains<OP, 16>(in, out, B, iters, consts, clocks, n0inv, s);
  }
  return -1;
}

template <int T, int L>
__global__ void __launch_bounds__(kThreads)
    ablation_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long B,
                    int mode, uint32_t alpha, int full_rounds, int partial_rounds,
                    const int32_t* __restrict__ consts, uint32_t n0inv) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Modulus<L> m;
  load_modulus(m, consts, n0inv);
  const int32_t* one = consts + L;
  const int32_t* ark = one + L;
  const int half = full_rounds / 2;
  uint32_t x[T][L];
  load_state<T, L>(x, in, B, b);
  if (mode > 0) {
#pragma unroll 1
    for (int r = 0; r < full_rounds + partial_rounds; ++r) {
      const bool full = r < half || r >= half + partial_rounds;
#pragma unroll
      for (int e = 0; e < T; ++e) {
        add_const(x[e], ark + (r * T + e) * L);
        if (mode > 1 && (full || e == 0)) mont_pow(x[e], alpha, m);
      }
    }
#pragma unroll
    for (int e = 0; e < T; ++e) mont_mul_const(x[e], x[e], one, m);
  }
  store_state<T, L>(out, x, B, b, m);
}

}  // namespace sponge

// Plain C entry points (ctypes): each returns cudaGetLastError() after the
// launch, or -1 for a shape it has no instantiation of.  Chains: t = chains
// per thread, L = 32-bit words per chain value (1; 2 for kWide; 11 for
// kMont), ``clocks`` a device int64[2] or null.  Ablation: (t, L) = (3, 11).
extern "C" int sponge_probe_chains(const int32_t* in, int32_t* out, long long B, int t, int L,
                                   int op, int iters, const int32_t* consts, long long* clocks,
                                   unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = op == sponge::kMont ? 11 : op == sponge::kWide ? 2 : 1;
  if (L != words) return -1;
  switch (op) {
    case sponge::kMul: return sponge::dispatch_chains<sponge::kMul>(in, out, B, t, iters, consts, clocks, n0inv, s);
    case sponge::kMad: return sponge::dispatch_chains<sponge::kMad>(in, out, B, t, iters, consts, clocks, n0inv, s);
    case sponge::kAdd: return sponge::dispatch_chains<sponge::kAdd>(in, out, B, t, iters, consts, clocks, n0inv, s);
    case sponge::kWide: return sponge::dispatch_chains<sponge::kWide>(in, out, B, t, iters, consts, clocks, n0inv, s);
    case sponge::kMont: return sponge::dispatch_chains<sponge::kMont>(in, out, B, t, iters, consts, clocks, n0inv, s);
    default: return -1;
  }
}

extern "C" int sponge_probe_ablation(const int32_t* in, int32_t* out, long long B, int t, int L,
                                     int mode, int alpha, int full_rounds, int partial_rounds,
                                     const int32_t* consts, unsigned n0inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t != 3 || L != 11) return -1;
  const unsigned blocks = static_cast<unsigned>((B + sponge::kThreads - 1) / sponge::kThreads);
  sponge::ablation_kernel<3, 11><<<blocks, sponge::kThreads, 0, s>>>(
      in, out, B, mode, static_cast<uint32_t>(alpha), full_rounds, partial_rounds, consts, n0inv);
  return static_cast<int>(cudaGetLastError());
}
