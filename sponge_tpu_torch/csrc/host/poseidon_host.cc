// Native host-side Poseidon permutation: scalar 4x64-bit Montgomery CIOS.
//
// The reference sponge is consumed on CPUs (Fiat-Shamir verifiers, proof
// checks, small transcripts) where a TPU dispatch round trip dwarfs the work;
// the framework's pure-python oracle is bit-exact but ~1000x slower than the
// reference's ark-ff Montgomery backend.  This file is the host-runtime
// equivalent of that backend (reference src/test.rs:10 uses
// MontBackend<.., 4>, i.e. 4 x 64-bit limbs) driving the exact round schedule
// of reference src/poseidon/mod.rs:95-118: R_F/2 full rounds (ARK add,
// x^alpha on all elements, dense MDS), R_P partial rounds (x^alpha on element
// 0 only), R_F/2 full rounds.
//
// All values cross the ABI in Montgomery form (R = 2^256) as 4 x 64-bit
// little-endian words; the Python wrapper (sponge_tpu/utils/native.py)
// performs the canonical <-> Montgomery conversion.
//
// Build: c++ -O3 -shared -fPIC -o libposeidonhost.so poseidon_host.cc

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int NW = 4;  // 4 x 64-bit words = 256 bits
using u64 = uint64_t;
using u128 = unsigned __int128;

struct FieldCtx64 {
  u64 p[NW];   // modulus, little-endian 64-bit words
  u64 n0inv;   // -p^{-1} mod 2^64
};

// out = a * b / 2^256 mod p  (CIOS, 64-bit words, 128-bit accumulators).
inline void mont_mul(const FieldCtx64& f, const u64* a, const u64* b, u64* out) {
  u64 t[NW + 2] = {0};
  for (int i = 0; i < NW; ++i) {
    u128 carry = 0;
    for (int j = 0; j < NW; ++j) {
      u128 cur = (u128)t[j] + (u128)a[j] * b[i] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[NW] + carry;
    t[NW] = (u64)cur;
    t[NW + 1] = (u64)(cur >> 64);

    u64 m = t[0] * f.n0inv;
    u128 cur2 = (u128)t[0] + (u128)m * f.p[0];
    carry = cur2 >> 64;
    for (int j = 1; j < NW; ++j) {
      u128 c2 = (u128)t[j] + (u128)m * f.p[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    u128 c3 = (u128)t[NW] + carry;
    t[NW - 1] = (u64)c3;
    t[NW] = t[NW + 1] + (u64)(c3 >> 64);
    t[NW + 1] = 0;
  }
  // Conditional subtraction of p.
  u64 res[NW];
  u128 borrow = 0;
  for (int j = 0; j < NW; ++j) {
    u128 d = (u128)t[j] - f.p[j] - borrow;
    res[j] = (u64)d;
    borrow = (d >> 127) & 1;
  }
  bool ge_p = (t[NW] != 0) || (borrow == 0);
  for (int j = 0; j < NW; ++j) out[j] = ge_p ? res[j] : t[j];
}

// out = a + b mod p (both < p).
inline void mont_add(const FieldCtx64& f, const u64* a, const u64* b, u64* out) {
  u64 s[NW];
  u128 carry = 0;
  for (int j = 0; j < NW; ++j) {
    u128 cur = (u128)a[j] + b[j] + carry;
    s[j] = (u64)cur;
    carry = cur >> 64;
  }
  u64 res[NW];
  u128 borrow = 0;
  for (int j = 0; j < NW; ++j) {
    u128 d = (u128)s[j] - f.p[j] - borrow;
    res[j] = (u64)d;
    borrow = (d >> 127) & 1;
  }
  bool ge_p = (carry != 0) || (borrow == 0);
  for (int j = 0; j < NW; ++j) out[j] = ge_p ? res[j] : s[j];
}

// out = a - b mod p (both < p).
inline void mont_sub(const FieldCtx64& f, const u64* a, const u64* b, u64* out) {
  u64 d[NW];
  u128 borrow = 0;
  for (int j = 0; j < NW; ++j) {
    u128 cur = (u128)a[j] - b[j] - borrow;
    d[j] = (u64)cur;
    borrow = (cur >> 127) & 1;
  }
  if (borrow) {  // wrapped below zero: add p back
    u128 carry = 0;
    for (int j = 0; j < NW; ++j) {
      u128 cur = (u128)d[j] + f.p[j] + carry;
      d[j] = (u64)cur;
      carry = cur >> 64;
    }
  }
  std::memcpy(out, d, sizeof(d));
}

// out = x^alpha (MSB-first square-and-multiply; alpha is small and static).
inline void mont_pow(const FieldCtx64& f, const u64* x, uint32_t alpha, u64* out) {
  u64 acc[NW];
  std::memcpy(acc, x, sizeof(acc));
  int top = 31 - __builtin_clz(alpha);
  for (int bit = top - 1; bit >= 0; --bit) {
    u64 sq[NW];
    mont_mul(f, acc, acc, sq);
    if ((alpha >> bit) & 1) {
      mont_mul(f, sq, x, acc);
    } else {
      std::memcpy(acc, sq, sizeof(sq));
    }
  }
  std::memcpy(out, acc, NW * sizeof(u64));
}

// out = c * x mod p for a small plain integer c (double-and-add over
// mont_add; scaling a Montgomery-form value by a plain int is
// representation-preserving).  c = 0 zeroes, c = 1 copies.
inline void mont_small_scale(const FieldCtx64& f, const u64* x, uint32_t c,
                             u64* out) {
  if (c == 0) {
    std::memset(out, 0, NW * sizeof(u64));
    return;
  }
  u64 acc[NW];
  std::memcpy(acc, x, sizeof(acc));
  int top = 31 - __builtin_clz(c);
  for (int bit = top - 1; bit >= 0; --bit) {
    mont_add(f, acc, acc, acc);
    if ((c >> bit) & 1) mont_add(f, acc, x, acc);
  }
  std::memcpy(out, acc, sizeof(acc));
}

// Poseidon2 tables (ePrint 2023/323 round schedule; nullable in PoseidonCtx —
// when set, permute_one runs the Poseidon2 schedule instead of Poseidon's).
struct Poseidon2Tables {
  const u64* ext_rc;      // (R_F * t * NW) words, Montgomery form
  const u64* int_rc;      // (R_P * NW) words, Montgomery form
  const int32_t* mat_e;   // (t * t) small plain ints
  const u64* diag_m1;     // (t * NW) words, Montgomery form of (mu_i - 1)
  // Nullable fast path: (mu_i - 1) as small plain ints (the paper's t = 2, 3
  // diagonals are {1, 2}) — the internal layer then needs no mont_mul at all.
  const int32_t* diag_small;
};

struct MonolithTables;
struct RescueTables;
struct GriffinTables;
struct AnemoiTables;
struct GmimcTables;

struct PoseidonCtx {
  FieldCtx64 f;
  int t, alpha, full_rounds, partial_rounds;
  const u64* ark;  // (R * t * NW) words, Montgomery form
  const u64* mds;  // (t * t * NW) words, Montgomery form
  // Optional sparse-MDS optimized partial-round tables (nullable; exact
  // algebraic identity — see sponge_tpu/poseidon/optimized.py).  Packed:
  // c_first (t) ‖ constants ((k-1)*t) ‖ row0 ((k-1)*t) ‖ col0 ((k-1)*(t-1))
  // ‖ dense (t*t), each element NW u64 Montgomery words.
  const u64* opt;
  const Poseidon2Tables* p2;      // non-null => Poseidon2 schedule
  const MonolithTables* mono;     // non-null => Monolith schedule
  const RescueTables* rescue;     // non-null => Rescue-Prime schedule
  const GriffinTables* griffin;   // non-null => Griffin schedule
  const AnemoiTables* anemoi;     // non-null => Anemoi schedule
  const GmimcTables* gmimc;       // non-null => GMiMC-erf schedule
};

inline void one_round(const PoseidonCtx& c, int r, bool full, u64* st,
                      u64* scratch) {
  const int t = c.t;
  // ARK add (mod.rs:76-80).
  for (int e = 0; e < t; ++e)
    mont_add(c.f, st + e * NW, c.ark + ((int64_t)r * t + e) * NW, st + e * NW);
  // S-box (mod.rs:63-74).
  if (full) {
    for (int e = 0; e < t; ++e) mont_pow(c.f, st + e * NW, c.alpha, st + e * NW);
  } else {
    mont_pow(c.f, st, c.alpha, st);
  }
  // Dense MDS (mod.rs:82-93): scratch = mds * st.
  for (int i = 0; i < t; ++i) {
    u64 acc[NW] = {0};
    for (int j = 0; j < t; ++j) {
      u64 prod[NW];
      mont_mul(c.f, c.mds + ((int64_t)i * t + j) * NW, st + j * NW, prod);
      mont_add(c.f, acc, prod, acc);
    }
    std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
  }
  std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
}

// Optimized partial-round chain (bit-identical to the naive rounds): element-0
// S-box between sparse matrices, one trailing dense matrix.  Mirrors
// eval_partial_chain_optimized in sponge_tpu/poseidon/optimized.py.
inline void partial_chain_opt(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const int k = c.partial_rounds;
  const u64* c_first = c.opt;
  const u64* consts = c_first + (int64_t)t * NW;
  const u64* row0 = consts + (int64_t)(k - 1) * t * NW;
  const u64* col0 = row0 + (int64_t)(k - 1) * t * NW;
  const u64* dense = col0 + (int64_t)(k - 1) * (t - 1) * NW;

  for (int e = 0; e < t; ++e)
    mont_add(c.f, st + e * NW, c_first + e * NW, st + e * NW);
  mont_pow(c.f, st, c.alpha, st);
  for (int r = 0; r < k - 1; ++r) {
    const u64* cr = consts + (int64_t)r * t * NW;
    for (int e = 0; e < t; ++e)
      mont_add(c.f, st + e * NW, cr + e * NW, st + e * NW);
    // Sparse apply: out0 = row0 · x;  rest_i = col0_i * x0 + x_i.
    const u64* r0 = row0 + (int64_t)r * t * NW;
    const u64* c0 = col0 + (int64_t)r * (t - 1) * NW;
    u64 acc[NW] = {0};
    for (int j = 0; j < t; ++j) {
      u64 prod[NW];
      mont_mul(c.f, r0 + j * NW, st + j * NW, prod);
      mont_add(c.f, acc, prod, acc);
    }
    for (int i = 1; i < t; ++i) {
      u64 prod[NW];
      mont_mul(c.f, c0 + (i - 1) * NW, st, prod);
      mont_add(c.f, st + i * NW, prod, st + i * NW);
    }
    std::memcpy(st, acc, NW * sizeof(u64));
    mont_pow(c.f, st, c.alpha, st);
  }
  // Trailing dense matrix.
  for (int i = 0; i < t; ++i) {
    u64 acc[NW] = {0};
    for (int j = 0; j < t; ++j) {
      u64 prod[NW];
      mont_mul(c.f, dense + ((int64_t)i * t + j) * NW, st + j * NW, prod);
      mont_add(c.f, acc, prod, acc);
    }
    std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
  }
  std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
}

// st = mat . st for a small-plain-int matrix (representation-preserving);
// shared by the Poseidon2 M_E and the Griffin linear layer.
inline void small_mat_apply(const PoseidonCtx& c, const int32_t* m, u64* st,
                            u64* scratch) {
  const int t = c.t;
  for (int i = 0; i < t; ++i) {
    u64 acc[NW] = {0};
    for (int j = 0; j < t; ++j) {
      u64 term[NW];
      mont_small_scale(c.f, st + j * NW, (uint32_t)m[i * t + j], term);
      mont_add(c.f, acc, term, acc);
    }
    std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
  }
  std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
}

// M_E . st via plain small-int scaling.
inline void p2_mat_e(const PoseidonCtx& c, u64* st, u64* scratch) {
  small_mat_apply(c, c.p2->mat_e, st, scratch);
}

// Poseidon2 permutation (ePrint 2023/323): initial M_E, R_F/2 external rounds
// (rc-add all, S-box all, M_E), R_P internal rounds (rc + S-box on element 0,
// M_I = J + diag(mu-1)), R_F/2 external rounds.
inline void permute_one_p2(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const Poseidon2Tables& p2 = *c.p2;
  const int half = c.full_rounds / 2;

  p2_mat_e(c, st, scratch);
  for (int phase = 0; phase < 2; ++phase) {
    const int lo = phase == 0 ? 0 : half;
    const int hi = phase == 0 ? half : c.full_rounds;
    for (int r = lo; r < hi; ++r) {
      for (int e = 0; e < t; ++e) {
        mont_add(c.f, st + e * NW, p2.ext_rc + ((int64_t)r * t + e) * NW,
                 st + e * NW);
        mont_pow(c.f, st + e * NW, c.alpha, st + e * NW);
      }
      p2_mat_e(c, st, scratch);
    }
    if (phase == 0) {
      for (int r = 0; r < c.partial_rounds; ++r) {
        mont_add(c.f, st, p2.int_rc + (int64_t)r * NW, st);
        mont_pow(c.f, st, c.alpha, st);
        u64 sigma[NW] = {0};
        for (int j = 0; j < t; ++j) mont_add(c.f, sigma, st + j * NW, sigma);
        for (int i = 0; i < t; ++i) {
          u64 prod[NW];
          if (p2.diag_small != nullptr) {
            mont_small_scale(c.f, st + i * NW, (uint32_t)p2.diag_small[i], prod);
          } else {
            mont_mul(c.f, st + i * NW, p2.diag_m1 + (int64_t)i * NW, prod);
          }
          mont_add(c.f, prod, sigma, scratch + i * NW);
        }
        std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
      }
    }
  }
}

// out = x^e for a wide (multi-word) exponent, MSB-first square-and-multiply.
// Used by Rescue-Prime's inverse S-box, whose exponent 1/alpha mod (p-1) is
// ~log2(p) bits.
inline void mont_pow_wide(const FieldCtx64& f, const u64* x, const u64* exp,
                          int n_words, const u64* one_mont, u64* out) {
  u64 acc[NW];
  std::memcpy(acc, one_mont, sizeof(acc));
  bool started = false;
  for (int w = n_words - 1; w >= 0; --w) {
    if (!started && exp[w] == 0) continue;
    int top = started ? 63 : 63 - __builtin_clzll(exp[w]);
    started = true;
    for (int bit = top; bit >= 0; --bit) {
      mont_mul(f, acc, acc, acc);
      if ((exp[w] >> bit) & 1) mont_mul(f, acc, x, acc);
    }
  }
  std::memcpy(out, acc, sizeof(acc));
}

// Rescue-Prime tables (ePrint 2020/1143 §2.4; see sponge_tpu/rescue).
struct RescueTables {
  const u64* rc;         // (2 * rounds * t * NW) words, Montgomery
  const u64* mds;        // (t * t * NW) words, Montgomery
  const u64* inv_alpha;  // (NW) words: plain exponent 1/alpha mod (p-1)
  const u64* one_mont;   // (NW) words: Montgomery form of 1
  int32_t rounds;
};

// Monolith tables (ePrint 2023/1025 structure; see
// sponge_tpu/monolith/config.py).  Only bar-safe fields with p < 2^64 are
// dispatched here (the Python wrapper gates), so a canonical value fits one
// u64 word and Bars run on it directly.
struct MonolithTables {
  const u64* rc;        // (rounds * t * NW) words, Montgomery (last row zero)
  const u64* concrete;  // (t * t * NW) words, Montgomery
  const u64* r2;        // (NW) words: R^2 mod p (to-Montgomery factor)
  int32_t rounds;
  int32_t bars;     // u: leading elements through Bar each round
  int32_t n_bits;   // modulus bit length
  int32_t bar_m;    // m of p = 2^n - 2^m + 1: extra chunk boundary when not
                    // byte-aligned (0/1 = no extra boundary); mirrors
                    // sponge_tpu/monolith/config.bar_chunks exactly
};

// The chi-like k-bit chunk S-box (config.chunk_sbox semantics).
inline u64 chi_chunk(u64 y, int k) {
  const u64 mask = (k == 64) ? ~0ull : ((1ull << k) - 1);
  auto rot = [&](u64 v, int r) {
    r %= k;
    return r == 0 ? v : ((v << r) | (v >> (k - r))) & mask;
  };
  const u64 nb = (~y) & mask;
  u64 z = (k % 2 == 0) ? (y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3)))
                       : (y ^ (rot(nb, 1) & rot(y, 2)));
  return rot(z, 1);
}

// Bar on a canonical value < p < 2^64: S-box 8-bit chunks with an extra
// boundary at bar_m when it is not byte-aligned (the same chunk loop as
// sponge_tpu/monolith/config.bar_chunks).
inline u64 bar_u64(u64 x, int n_bits, int bar_m) {
  u64 out = 0;
  int bit = 0;
  while (bit < n_bits) {
    int next = (bit / 8 + 1) * 8;
    if (next >= n_bits) next = n_bits;
    if (bar_m > 1 && bit < bar_m && bar_m < next) next = bar_m;
    const int k = next - bit;
    out |= chi_chunk((x >> bit) & ((1ull << k) - 1), k) << bit;
    bit = next;
  }
  return out;
}

// Monolith permutation: Concrete, then R rounds of Bars -> Bricks ->
// Concrete -> + rc (last row zero).  State in Montgomery form; Bars cross to
// canonical via REDC-by-1 and return via the R^2 multiply.
inline void permute_one_monolith(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const MonolithTables& m = *c.mono;
  static const u64 one_plain[NW] = {1, 0, 0, 0};

  auto concrete = [&](u64* s) {
    for (int i = 0; i < t; ++i) {
      u64 acc[NW] = {0};
      for (int j = 0; j < t; ++j) {
        u64 prod[NW];
        mont_mul(c.f, m.concrete + ((int64_t)i * t + j) * NW, s + j * NW, prod);
        mont_add(c.f, acc, prod, acc);
      }
      std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
    }
    std::memcpy(s, scratch, (size_t)t * NW * sizeof(u64));
  };

  concrete(st);
  for (int r = 0; r < m.rounds; ++r) {
    // Bars.
    for (int e = 0; e < m.bars; ++e) {
      u64 plain[NW];
      mont_mul(c.f, st + e * NW, one_plain, plain);  // canonical < p < 2^64
      plain[0] = bar_u64(plain[0], m.n_bits, m.bar_m);
      mont_mul(c.f, plain, m.r2, st + e * NW);  // back to Montgomery
    }
    // Bricks: x_i += x_{i-1}^2 over the ORIGINAL values (parallel Feistel).
    for (int e = 0; e < t - 1; ++e)
      mont_mul(c.f, st + e * NW, st + e * NW, scratch + e * NW);
    for (int i = t - 1; i >= 1; --i)
      mont_add(c.f, st + i * NW, scratch + (i - 1) * NW, st + i * NW);
    concrete(st);
    for (int e = 0; e < t; ++e)
      mont_add(c.f, st + e * NW, m.rc + ((int64_t)r * t + e) * NW, st + e * NW);
  }
}

// Rescue-Prime permutation: per round, forward S-box x^alpha / MDS / rc,
// then inverse S-box x^(1/alpha) / MDS / rc (ePrint 2020/1143 §2.4).
inline void permute_one_rescue(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const RescueTables& rt = *c.rescue;

  auto mds = [&](u64* s) {
    for (int i = 0; i < t; ++i) {
      u64 acc[NW] = {0};
      for (int j = 0; j < t; ++j) {
        u64 prod[NW];
        mont_mul(c.f, rt.mds + ((int64_t)i * t + j) * NW, s + j * NW, prod);
        mont_add(c.f, acc, prod, acc);
      }
      std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
    }
    std::memcpy(s, scratch, (size_t)t * NW * sizeof(u64));
  };

  for (int r = 0; r < rt.rounds; ++r) {
    for (int e = 0; e < t; ++e) mont_pow(c.f, st + e * NW, c.alpha, st + e * NW);
    mds(st);
    for (int e = 0; e < t; ++e)
      mont_add(c.f, st + e * NW, rt.rc + ((int64_t)(2 * r) * t + e) * NW,
               st + e * NW);
    for (int e = 0; e < t; ++e)
      mont_pow_wide(c.f, st + e * NW, rt.inv_alpha, NW, rt.one_mont,
                    st + e * NW);
    mds(st);
    for (int e = 0; e < t; ++e)
      mont_add(c.f, st + e * NW, rt.rc + ((int64_t)(2 * r + 1) * t + e) * NW,
               st + e * NW);
  }
}

// Griffin tables (ePrint 2022/403 structure; see sponge_tpu/griffin).
struct GriffinTables {
  const u64* rc;         // ((rounds-1) * t * NW) words, Montgomery
  const int32_t* mat_e;  // (t * t) small plain ints (Poseidon2's matrices)
  const u64* qa;         // ((t-2) * NW) words: alpha_i, Montgomery
  const u64* qb;         // ((t-2) * NW) words: beta_i, Montgomery
  const u64* inv_alpha;  // (NW) words: plain exponent 1/alpha mod (p-1)
  const u64* one_mont;   // (NW) words: Montgomery form of 1
  int32_t rounds;
};

// Griffin-pi permutation (ePrint 2022/403; structure documented in
// sponge_tpu/griffin/config.py): initial linear layer, then R rounds of
// nonlinear layer (y0 = x0^(1/d), y1 = x1^d, quadratic-gated multiplicative
// elements reading the ORIGINAL x_{i-1}) / linear layer / rc add (except the
// last round).
inline void permute_one_griffin(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const GriffinTables& g = *c.griffin;

  small_mat_apply(c, g.mat_e, st, scratch);
  for (int r = 0; r < g.rounds; ++r) {
    u64 y0[NW], y1[NW];
    mont_pow_wide(c.f, st, g.inv_alpha, NW, g.one_mont, y0);
    mont_pow(c.f, st + NW, c.alpha, y1);
    std::memcpy(scratch, y0, sizeof(y0));
    std::memcpy(scratch + NW, y1, sizeof(y1));
    for (int i = 2; i < t; ++i) {
      u64 li[NW];
      mont_small_scale(c.f, y0, (uint32_t)(i - 1), li);
      mont_add(c.f, li, y1, li);
      if (i >= 3) mont_add(c.f, li, st + (int64_t)(i - 1) * NW, li);
      u64 sq[NW], al[NW];
      mont_mul(c.f, li, li, sq);
      mont_mul(c.f, li, g.qa + (int64_t)(i - 2) * NW, al);
      mont_add(c.f, sq, al, sq);
      mont_add(c.f, sq, g.qb + (int64_t)(i - 2) * NW, sq);
      mont_mul(c.f, st + (int64_t)i * NW, sq, scratch + (int64_t)i * NW);
    }
    std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
    small_mat_apply(c, g.mat_e, st, scratch);
    if (r < g.rounds - 1)
      for (int e = 0; e < t; ++e)
        mont_add(c.f, st + e * NW, g.rc + ((int64_t)r * t + e) * NW,
                 st + e * NW);
  }
}

// Anemoi tables (ePrint 2022/840 structure; see sponge_tpu/anemoi).
// State is two columns X = st[0..l), Y = st[l..2l); the open Flystel mixes
// one wide inverse power map with two quadratics in the generator g.
struct AnemoiTables {
  const u64* rc_x;       // (rounds * l * NW) words, Montgomery
  const u64* rc_y;       // (rounds * l * NW) words, Montgomery
  const u64* mat;        // (l * l * NW) words, Montgomery (identity at l=1)
  const u64* g;          // (NW) words: Montgomery g
  const u64* g_inv;      // (NW) words: Montgomery g^{-1}
  const u64* inv_alpha;  // (NW) words: plain exponent 1/alpha mod (p-1)
  const u64* one_mont;   // (NW) words: Montgomery form of 1
  int32_t rounds;
};

// Diffusion: M_x on X, M_x on rot-left-1(Y), then the PHT Y += X; X += Y.
inline void anemoi_diffusion(const PoseidonCtx& c, u64* st, u64* scratch) {
  const AnemoiTables& a = *c.anemoi;
  const int l = c.t / 2;
  if (l > 1) {
    // rotate Y left by 1 into scratch, then multiply both columns by M_x.
    for (int j = 0; j < l; ++j)
      std::memcpy(scratch + j * NW, st + (l + (j + 1) % l) * NW,
                  NW * sizeof(u64));
    std::memcpy(st + l * NW, scratch, (size_t)l * NW * sizeof(u64));
    for (int col = 0; col < 2; ++col) {
      u64* v = st + col * l * NW;
      for (int i = 0; i < l; ++i) {
        u64 acc[NW] = {0};
        for (int j = 0; j < l; ++j) {
          u64 prod[NW];
          mont_mul(c.f, a.mat + ((int64_t)i * l + j) * NW, v + j * NW, prod);
          mont_add(c.f, acc, prod, acc);
        }
        std::memcpy(scratch + i * NW, acc, NW * sizeof(u64));
      }
      std::memcpy(v, scratch, (size_t)l * NW * sizeof(u64));
    }
  }
  for (int j = 0; j < l; ++j)
    mont_add(c.f, st + (l + j) * NW, st + j * NW, st + (l + j) * NW);
  for (int j = 0; j < l; ++j)
    mont_add(c.f, st + j * NW, st + (l + j) * NW, st + j * NW);
}

// Anemoi permutation: per round, constants -> diffusion -> open Flystel on
// each (x_j, y_j) pair; one extra diffusion closes the permutation.
inline void permute_one_anemoi(const PoseidonCtx& c, u64* st, u64* scratch) {
  const AnemoiTables& a = *c.anemoi;
  const int l = c.t / 2;
  for (int r = 0; r < a.rounds; ++r) {
    for (int j = 0; j < l; ++j) {
      mont_add(c.f, st + j * NW, a.rc_x + ((int64_t)r * l + j) * NW,
               st + j * NW);
      mont_add(c.f, st + (l + j) * NW, a.rc_y + ((int64_t)r * l + j) * NW,
               st + (l + j) * NW);
    }
    anemoi_diffusion(c, st, scratch);
    for (int j = 0; j < l; ++j) {
      u64* x = st + j * NW;
      u64* y = st + (l + j) * NW;
      u64 q[NW], u[NW], v[NW];
      mont_mul(c.f, y, y, q);
      mont_mul(c.f, q, a.g, q);
      mont_add(c.f, q, a.g_inv, q);
      mont_sub(c.f, x, q, u);  // u = x - (g*y^2 + g^-1)
      mont_pow_wide(c.f, u, a.inv_alpha, NW, a.one_mont, q);
      mont_sub(c.f, y, q, v);  // v = y - u^(1/alpha)
      mont_mul(c.f, v, v, q);
      mont_mul(c.f, q, a.g, q);
      mont_add(c.f, u, q, x);  // w = u + g*v^2
      std::memcpy(y, v, NW * sizeof(u64));
    }
  }
  anemoi_diffusion(c, st, scratch);
}

// GMiMC-erf tables (ePrint 2019/397 structure; see sponge_tpu/gmimc).
struct GmimcTables {
  const u64* rc;  // (rounds * NW) words, Montgomery form
  int32_t rounds;
};

// GMiMC-erf permutation: per round, F = (x_0 + c_r)^alpha fans into every
// other branch, then the state rotates left (the original x_0 to the back).
inline void permute_one_gmimc(const PoseidonCtx& c, u64* st, u64* scratch) {
  const int t = c.t;
  const GmimcTables& g = *c.gmimc;
  for (int r = 0; r < g.rounds; ++r) {
    u64 f[NW];
    mont_add(c.f, st, g.rc + (int64_t)r * NW, f);
    mont_pow(c.f, f, c.alpha, f);
    std::memcpy(scratch + (int64_t)(t - 1) * NW, st, NW * sizeof(u64));
    for (int i = 1; i < t; ++i)
      mont_add(c.f, st + (int64_t)i * NW, f, scratch + (int64_t)(i - 1) * NW);
    std::memcpy(st, scratch, (size_t)t * NW * sizeof(u64));
  }
}

inline void permute_one(const PoseidonCtx& c, u64* st, u64* scratch) {
  if (c.gmimc != nullptr) {
    permute_one_gmimc(c, st, scratch);
    return;
  }
  if (c.anemoi != nullptr) {
    permute_one_anemoi(c, st, scratch);
    return;
  }
  if (c.griffin != nullptr) {
    permute_one_griffin(c, st, scratch);
    return;
  }
  if (c.rescue != nullptr) {
    permute_one_rescue(c, st, scratch);
    return;
  }
  if (c.mono != nullptr) {
    permute_one_monolith(c, st, scratch);
    return;
  }
  if (c.p2 != nullptr) {
    permute_one_p2(c, st, scratch);
    return;
  }
  const int half = c.full_rounds / 2;
  const int rounds = c.full_rounds + c.partial_rounds;
  for (int r = 0; r < half; ++r) one_round(c, r, true, st, scratch);
  if (c.opt != nullptr && c.partial_rounds >= 2) {
    partial_chain_opt(c, st, scratch);
  } else {
    for (int r = half; r < half + c.partial_rounds; ++r)
      one_round(c, r, false, st, scratch);
  }
  for (int r = half + c.partial_rounds; r < rounds; ++r)
    one_round(c, r, true, st, scratch);
}

inline PoseidonCtx make_ctx(const u64* fctx, int32_t t, int32_t alpha,
                            int32_t full_rounds, int32_t partial_rounds,
                            const u64* ark, const u64* mds, const u64* opt,
                            const Poseidon2Tables* p2,
                            const MonolithTables* mono = nullptr,
                            const RescueTables* rescue = nullptr,
                            const GriffinTables* griffin = nullptr,
                            const AnemoiTables* anemoi = nullptr,
                            const GmimcTables* gmimc = nullptr) {
  PoseidonCtx c;
  std::memcpy(c.f.p, fctx, NW * sizeof(u64));
  c.f.n0inv = fctx[NW];
  c.t = t;
  c.alpha = alpha;
  c.full_rounds = full_rounds;
  c.partial_rounds = partial_rounds;
  c.ark = ark;
  c.mds = mds;
  c.opt = opt;
  c.p2 = p2;
  c.mono = mono;
  c.rescue = rescue;
  c.griffin = griffin;
  c.anemoi = anemoi;
  c.gmimc = gmimc;
  return c;
}

void batch_permute(const PoseidonCtx& c, u64* states, int64_t n,
                   int32_t n_threads) {
  const int t = c.t;
  auto run = [&](int64_t lo, int64_t hi) {
    std::vector<u64> scratch((size_t)t * NW);
    for (int64_t i = lo; i < hi; ++i)
      permute_one(c, states + (int64_t)i * t * NW, scratch.data());
  };
  if (n_threads <= 1 || n < 2 * n_threads) {
    run(0, n);
    return;
  }
  std::vector<std::thread> workers;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; ++w) {
    int64_t lo = (int64_t)w * per;
    if (lo >= n) break;
    int64_t hi = lo + per < n ? lo + per : n;
    workers.emplace_back(run, lo, hi);
  }
  for (auto& th : workers) th.join();
}

// Duplex-sponge segment driver: runs an absorb/squeeze schedule over a live
// sponge exactly like the reference state machine (mod.rs:121-182, 232-341),
// so a transcript segment needs ONE ctypes call.  steps: pairs (kind, count)
// with kind 0 = absorb, 1 = squeeze-native; elems: all absorbed elements in
// order; out: all squeezed elements in order.  state_io: t elements (in/out —
// zero it for a fresh sponge, mod.rs:220); bk: {mode (0 absorb / 1 squeeze),
// index} bookkeeping (in/out).  capacity is the reference's fixed layout:
// state[0..capacity) untouched by IO.  Permutation-family-agnostic: the
// schedule drives whatever permute_one dispatches to for this ctx.
void sponge_run(const PoseidonCtx& c, int32_t rate, int32_t capacity,
                const int32_t* steps, int64_t n_steps, const u64* elems,
                u64* out, u64* state_io, int32_t* bk) {
  const int t = c.t;
  std::vector<u64> state(state_io, state_io + (size_t)t * NW);
  std::vector<u64> scratch((size_t)t * NW);
  int mode = bk[0];  // 0 = absorbing, 1 = squeezing
  int index = bk[1];
  int64_t epos = 0, opos = 0;

  for (int64_t s = 0; s < n_steps; ++s) {
    int kind = steps[2 * s];
    int64_t count = steps[2 * s + 1];
    if (kind == 0) {
      if (count == 0) continue;
      int start;
      if (mode == 0) {
        start = index;
        if (start == rate) {
          permute_one(c, state.data(), scratch.data());
          start = 0;
        }
      } else {
        permute_one(c, state.data(), scratch.data());
        start = 0;
      }
      // absorb_internal (mod.rs:121-150): ADD into the rate region.
      int64_t remaining = count;
      while (true) {
        if (start + remaining <= rate) {
          for (int64_t k = 0; k < remaining; ++k)
            mont_add(c.f, state.data() + (capacity + start + k) * NW,
                     elems + (epos + k) * NW,
                     state.data() + (capacity + start + k) * NW);
          epos += remaining;
          mode = 0;
          index = (int)(start + remaining);
          break;
        }
        int64_t take = rate - start;
        for (int64_t k = 0; k < take; ++k)
          mont_add(c.f, state.data() + (capacity + start + k) * NW,
                   elems + (epos + k) * NW,
                   state.data() + (capacity + start + k) * NW);
        epos += take;
        permute_one(c, state.data(), scratch.data());
        remaining -= take;
        start = 0;
      }
    } else {
      int start;
      if (mode == 0) {
        permute_one(c, state.data(), scratch.data());
        start = 0;
      } else {
        start = index;
        if (start == rate) {
          permute_one(c, state.data(), scratch.data());
          start = 0;
        }
      }
      // squeeze_internal (mod.rs:153-182) incl. the remaining==rate
      // no-permute quirk (mod.rs:174-177).
      int64_t remaining = count;
      while (true) {
        if (start + remaining <= rate) {
          std::memcpy(out + opos * NW, state.data() + (capacity + start) * NW,
                      (size_t)remaining * NW * sizeof(u64));
          opos += remaining;
          mode = 1;
          index = (int)(start + remaining);
          break;
        }
        int64_t take = rate - start;
        std::memcpy(out + opos * NW, state.data() + (capacity + start) * NW,
                    (size_t)take * NW * sizeof(u64));
        opos += take;
        if (remaining != rate) permute_one(c, state.data(), scratch.data());
        remaining -= take;
        start = 0;
      }
    }
  }

  std::memcpy(state_io, state.data(), state.size() * sizeof(u64));
  bk[0] = mode;
  bk[1] = index;
}

}  // namespace

extern "C" {

// fctx: p (4 x u64 LE) ‖ n0inv (1 x u64)
// ark:  (full_rounds + partial_rounds) * t elements, mds: t * t elements,
//       each element 4 x u64 LE Montgomery form.
// opt:  nullable packed optimized-partial-round tables (see PoseidonCtx).
// states: n * t elements, Montgomery form, permuted IN PLACE.
// n_threads: worker threads for the batch (<=1 = single-threaded).
void poseidon_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                           int32_t full_rounds, int32_t partial_rounds,
                           const u64* ark, const u64* mds, const u64* opt,
                           u64* states, int64_t n, int32_t n_threads) {
  PoseidonCtx c = make_ctx(fctx, t, alpha, full_rounds, partial_rounds, ark,
                           mds, opt, nullptr);
  batch_permute(c, states, n, n_threads);
}

void poseidon_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                         int32_t full_rounds, int32_t partial_rounds,
                         int32_t rate, int32_t capacity, const u64* ark,
                         const u64* mds, const u64* opt, const int32_t* steps,
                         int64_t n_steps, const u64* elems, u64* out,
                         u64* state_io, int32_t* bk) {
  PoseidonCtx c = make_ctx(fctx, t, alpha, full_rounds, partial_rounds, ark,
                           mds, opt, nullptr);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// Poseidon2 entries (ePrint 2023/323).  ext_rc: R_F * t elements; int_rc:
// R_P elements; mat_e: t*t small plain int32; diag_m1: t elements in
// Montgomery form of (mu_i - 1).  Everything else as above.
void poseidon2_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                            int32_t full_rounds, int32_t partial_rounds,
                            const u64* ext_rc, const u64* int_rc,
                            const int32_t* mat_e, const u64* diag_m1,
                            const int32_t* diag_small, u64* states, int64_t n,
                            int32_t n_threads) {
  Poseidon2Tables p2{ext_rc, int_rc, mat_e, diag_m1, diag_small};
  PoseidonCtx c = make_ctx(fctx, t, alpha, full_rounds, partial_rounds,
                           nullptr, nullptr, nullptr, &p2);
  batch_permute(c, states, n, n_threads);
}

void poseidon2_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                          int32_t full_rounds, int32_t partial_rounds,
                          int32_t rate, int32_t capacity, const u64* ext_rc,
                          const u64* int_rc, const int32_t* mat_e,
                          const u64* diag_m1, const int32_t* diag_small,
                          const int32_t* steps, int64_t n_steps,
                          const u64* elems, u64* out, u64* state_io,
                          int32_t* bk) {
  Poseidon2Tables p2{ext_rc, int_rc, mat_e, diag_m1, diag_small};
  PoseidonCtx c = make_ctx(fctx, t, alpha, full_rounds, partial_rounds,
                           nullptr, nullptr, nullptr, &p2);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// Monolith entries (ePrint 2023/1025 structure).  rc: rounds * t elements
// (Montgomery, last row zero); concrete: t*t elements (Montgomery); r2: one
// element (R^2 mod p); n_bits: modulus bit length (bar chunking).  The
// caller guarantees the field is bar-safe with p < 2^64.
void monolith_permute_host(const u64* fctx, int32_t t, int32_t rounds,
                           int32_t bars, int32_t n_bits, int32_t bar_m,
                           const u64* rc, const u64* concrete, const u64* r2,
                           u64* states, int64_t n, int32_t n_threads) {
  MonolithTables m{rc, concrete, r2, rounds, bars, n_bits, bar_m};
  PoseidonCtx c =
      make_ctx(fctx, t, 2, 0, 0, nullptr, nullptr, nullptr, nullptr, &m);
  batch_permute(c, states, n, n_threads);
}

void monolith_sponge_run(const u64* fctx, int32_t t, int32_t rounds,
                         int32_t bars, int32_t n_bits, int32_t bar_m,
                         int32_t rate, int32_t capacity, const u64* rc,
                         const u64* concrete, const u64* r2,
                         const int32_t* steps, int64_t n_steps,
                         const u64* elems, u64* out, u64* state_io,
                         int32_t* bk) {
  MonolithTables m{rc, concrete, r2, rounds, bars, n_bits, bar_m};
  PoseidonCtx c =
      make_ctx(fctx, t, 2, 0, 0, nullptr, nullptr, nullptr, nullptr, &m);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// Rescue-Prime entries (ePrint 2020/1143).  rc: 2 * rounds * t elements
// (Montgomery); mds: t*t elements (Montgomery); inv_alpha: 4 u64 LE plain
// exponent words (1/alpha mod p-1); one_mont: Montgomery form of 1.
void rescue_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                         int32_t rounds, const u64* rc, const u64* mds,
                         const u64* inv_alpha, const u64* one_mont,
                         u64* states, int64_t n, int32_t n_threads) {
  RescueTables rt{rc, mds, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, &rt);
  batch_permute(c, states, n, n_threads);
}

void rescue_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                       int32_t rounds, int32_t rate, int32_t capacity,
                       const u64* rc, const u64* mds, const u64* inv_alpha,
                       const u64* one_mont, const int32_t* steps,
                       int64_t n_steps, const u64* elems, u64* out,
                       u64* state_io, int32_t* bk) {
  RescueTables rt{rc, mds, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, &rt);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// Anemoi entries (ePrint 2022/840 structure).  rc_x/rc_y: rounds * l
// elements each (Montgomery); mat: l*l elements (Montgomery; identity at
// l=1); g/g_inv: one element each (Montgomery); inv_alpha: 4 u64 LE plain
// exponent words (1/alpha mod p-1); one_mont: Montgomery form of 1.
void anemoi_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                         int32_t rounds, const u64* rc_x, const u64* rc_y,
                         const u64* mat, const u64* g, const u64* g_inv,
                         const u64* inv_alpha, const u64* one_mont,
                         u64* states, int64_t n, int32_t n_threads) {
  AnemoiTables a{rc_x, rc_y, mat, g, g_inv, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, &a);
  batch_permute(c, states, n, n_threads);
}

void anemoi_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                       int32_t rounds, int32_t rate, int32_t capacity,
                       const u64* rc_x, const u64* rc_y, const u64* mat,
                       const u64* g, const u64* g_inv, const u64* inv_alpha,
                       const u64* one_mont, const int32_t* steps,
                       int64_t n_steps, const u64* elems, u64* out,
                       u64* state_io, int32_t* bk) {
  AnemoiTables a{rc_x, rc_y, mat, g, g_inv, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, &a);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// Griffin entries (ePrint 2022/403 structure).  rc: (rounds-1) * t elements
// (Montgomery); mat_e: t*t small plain int32 (Poseidon2's matrices); qa/qb:
// t-2 elements each (Montgomery alpha_i/beta_i); inv_alpha: 4 u64 LE plain
// exponent words (1/alpha mod p-1); one_mont: Montgomery form of 1.
void griffin_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                          int32_t rounds, const u64* rc, const int32_t* mat_e,
                          const u64* qa, const u64* qb, const u64* inv_alpha,
                          const u64* one_mont, u64* states, int64_t n,
                          int32_t n_threads) {
  GriffinTables g{rc, mat_e, qa, qb, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, &g);
  batch_permute(c, states, n, n_threads);
}

void griffin_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                        int32_t rounds, int32_t rate, int32_t capacity,
                        const u64* rc, const int32_t* mat_e, const u64* qa,
                        const u64* qb, const u64* inv_alpha,
                        const u64* one_mont, const int32_t* steps,
                        int64_t n_steps, const u64* elems, u64* out,
                        u64* state_io, int32_t* bk) {
  GriffinTables g{rc, mat_e, qa, qb, inv_alpha, one_mont, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, &g);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

// GMiMC-erf entries (ePrint 2019/397 structure).  rc: rounds elements
// (Montgomery — the only constants the family has).
void gmimc_permute_host(const u64* fctx, int32_t t, int32_t alpha,
                        int32_t rounds, const u64* rc, u64* states, int64_t n,
                        int32_t n_threads) {
  GmimcTables g{rc, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, &g);
  batch_permute(c, states, n, n_threads);
}

void gmimc_sponge_run(const u64* fctx, int32_t t, int32_t alpha,
                      int32_t rounds, int32_t rate, int32_t capacity,
                      const u64* rc, const int32_t* steps, int64_t n_steps,
                      const u64* elems, u64* out, u64* state_io,
                      int32_t* bk) {
  GmimcTables g{rc, rounds};
  PoseidonCtx c = make_ctx(fctx, t, alpha, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, &g);
  sponge_run(c, rate, capacity, steps, n_steps, elems, out, state_io, bk);
}

}  // extern "C"
