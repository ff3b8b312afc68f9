// Native host-side codec: canonical byte values <-> Montgomery 24-bit limb planes.
//
// The port stores field elements as 11 x 24-bit limbs in int32 planes
// (see sponge_tpu_torch/fields.py).  Converting between canonical integers
// and Montgomery-form limbs takes one modular multiplication per element
// (by the encode or decode multiplier): host work that gates absorb and
// decode throughput for large batches when done in Python.  This file does
// the conversion in portable C++ (schoolbook 32-bit-word Montgomery
// arithmetic with 64-bit accumulators, base-2^32 CIOS), with a C ABI for
// ctypes.  It is the 24-bit-limb counterpart of csrc/host_codec.cc, which
// packs the same R = 2^264 values as 22 x 12-bit limbs.
//
// Build: c++ -O3 -shared -fPIC -o libhostcodec.so host_codec.cc

#include <cstdint>
#include <cstring>

namespace {

constexpr int NWORDS = 8;     // 8 x 32-bit words = 256 bits
constexpr int NLIMBS = 11;    // 11 x 24-bit limbs = 264 bits (matches fields.py)
constexpr int LIMB_BITS = 24;
constexpr uint64_t LIMB_MASK = 0xFFFFFF;

struct FieldCtx {
  uint32_t p[NWORDS];     // modulus, little-endian 32-bit words
  uint32_t enc[NWORDS];   // encode multiplier c_enc
  uint32_t dec[NWORDS];   // decode multiplier c_dec
  uint32_t n0inv;         // -p^{-1} mod 2^32
};
// The limb plane uses R_dev = 2^264 while this file's word-CIOS uses
// R_c = 2^256.  mont_mul(x, c) computes x * c / R_c mod p, so:
//   encode: x -> x * R_dev       needs c_enc = R_c * R_dev mod p
//   decode: y = x * R_dev -> x   needs c_dec = R_c / R_dev mod p

// out = a * b / 2^256 mod p (CIOS over 32-bit words).
inline void mont_mul(const FieldCtx& f, const uint32_t* a, const uint32_t* b,
                     uint32_t* out) {
  uint32_t t[NWORDS + 2] = {0};
  for (int i = 0; i < NWORDS; ++i) {
    // t += a * b[i]
    uint64_t carry = 0;
    for (int j = 0; j < NWORDS; ++j) {
      uint64_t cur = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + carry;
      t[j] = (uint32_t)cur;
      carry = cur >> 32;
    }
    uint64_t cur = (uint64_t)t[NWORDS] + carry;
    t[NWORDS] = (uint32_t)cur;
    t[NWORDS + 1] = (uint32_t)(cur >> 32);

    // m = t[0] * n0inv mod 2^32;  t += m * p;  t >>= 32
    uint32_t m = t[0] * f.n0inv;
    uint64_t cur2 = (uint64_t)t[0] + (uint64_t)m * f.p[0];
    carry = cur2 >> 32;
    for (int j = 1; j < NWORDS; ++j) {
      uint64_t c2 = (uint64_t)t[j] + (uint64_t)m * f.p[j] + carry;
      t[j - 1] = (uint32_t)c2;
      carry = c2 >> 32;
    }
    uint64_t c3 = (uint64_t)t[NWORDS] + carry;
    t[NWORDS - 1] = (uint32_t)c3;
    t[NWORDS] = t[NWORDS + 1] + (uint32_t)(c3 >> 32);
    t[NWORDS + 1] = 0;
  }
  // Conditional subtraction: result in t[0..NWORDS) (+ t[NWORDS] overflow bit).
  uint64_t borrow = 0;
  uint32_t res[NWORDS];
  for (int j = 0; j < NWORDS; ++j) {
    uint64_t d = (uint64_t)t[j] - f.p[j] - borrow;
    res[j] = (uint32_t)d;
    borrow = (d >> 63) & 1;  // 1 if underflow
  }
  bool ge_p = (t[NWORDS] != 0) || (borrow == 0);
  for (int j = 0; j < NWORDS; ++j) out[j] = ge_p ? res[j] : t[j];
}

inline void words_to_limbs(const uint32_t* w, int32_t* limbs) {
  // 8 x 32-bit words -> 11 x 24-bit limbs (little-endian bit order).
  uint64_t acc = 0;
  int acc_bits = 0, wi = 0;
  for (int l = 0; l < NLIMBS; ++l) {
    if (acc_bits < LIMB_BITS && wi < NWORDS) {
      acc |= (uint64_t)w[wi++] << acc_bits;
      acc_bits += 32;
    }
    limbs[l] = (int32_t)(acc & LIMB_MASK);
    acc >>= LIMB_BITS;
    acc_bits -= LIMB_BITS;
    if (acc_bits < 0) acc_bits = 0;
  }
}

inline void limbs_to_words(const FieldCtx& f, const int32_t* limbs, uint32_t* w) {
  // 11 x 24-bit limbs -> 8 x 32-bit words by Horner from the top limb.
  // Accepts REDUNDANT limbs (non-negative, of a value below p * 2^12, which
  // decode_mont_plane_native checks before the call): the Horner
  // accumulates into 9 words (288 bits), and a binary shift-and-subtract
  // (conditional subtract of p << k for k = 11..0) reduces below p < 2^255
  // before narrowing to 8 words, which is exact for any value < p * 2^12.
  uint32_t w9[NWORDS + 1] = {0};
  for (int l = NLIMBS - 1; l >= 0; --l) {
    uint64_t carry = (uint64_t)(uint32_t)limbs[l];  // w9 = (w9 << 24) + limb
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint64_t cur = ((uint64_t)w9[j] << LIMB_BITS) + carry;
      w9[j] = (uint32_t)cur;
      carry = cur >> 32;
    }
  }
  for (int k = 11; k >= 0; --k) {
    // pk = p << k over 9 words.
    uint32_t pk[NWORDS + 1];
    uint32_t hi = 0;
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint32_t pj = j < NWORDS ? f.p[j] : 0;
      pk[j] = (k == 0) ? pj : ((pj << k) | hi);
      hi = (k == 0) ? 0 : (uint32_t)((uint64_t)pj >> (32 - k));
    }
    uint32_t d[NWORDS + 1];
    uint64_t borrow = 0;
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint64_t cur = (uint64_t)w9[j] - pk[j] - borrow;
      d[j] = (uint32_t)cur;
      borrow = (cur >> 63) & 1;
    }
    if (!borrow) std::memcpy(w9, d, sizeof(d));  // w9 >= p<<k: keep difference
  }
  std::memcpy(w, w9, NWORDS * sizeof(uint32_t));
}

}  // namespace

extern "C" {

static void load_ctx(const uint32_t* fctx, FieldCtx* f) {
  std::memcpy(f->p, fctx, sizeof(f->p));
  std::memcpy(f->enc, fctx + NWORDS, sizeof(f->enc));
  std::memcpy(f->dec, fctx + 2 * NWORDS, sizeof(f->dec));
  f->n0inv = fctx[3 * NWORDS];
}

// in:  n elements as 32-byte little-endian canonical values (n * 32 bytes)
// out: Montgomery limb plane, limb-major: out[l * n + i] (NLIMBS * n int32)
// fctx: p (8 words LE) ‖ c_enc (8) ‖ c_dec (8) ‖ n0inv (1)
void encode_mont_plane(const uint8_t* in, int64_t n, const uint32_t* fctx,
                       int32_t* out) {
  FieldCtx f;
  load_ctx(fctx, &f);
  int32_t limbs[NLIMBS];
  uint32_t words[NWORDS], mont[NWORDS];
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(words, in + i * 32, 32);
    mont_mul(f, words, f.enc, mont);  // x * c_enc / R_c = x * R_dev
    words_to_limbs(mont, limbs);
    for (int l = 0; l < NLIMBS; ++l) out[(int64_t)l * n + i] = limbs[l];
  }
}

// in:  Montgomery limb plane, limb-major (limbs may be redundant)
// out: n elements as 32-byte little-endian canonical values
void decode_mont_plane(const int32_t* in, int64_t n, const uint32_t* fctx,
                       uint8_t* out) {
  FieldCtx f;
  load_ctx(fctx, &f);
  int32_t limbs[NLIMBS];
  uint32_t words[NWORDS], plain[NWORDS];
  for (int64_t i = 0; i < n; ++i) {
    for (int l = 0; l < NLIMBS; ++l) limbs[l] = in[(int64_t)l * n + i];
    limbs_to_words(f, limbs, words);
    mont_mul(f, words, f.dec, plain);  // (x * R_dev) * c_dec / R_c = x
    std::memcpy(out + i * 32, plain, 32);
  }
}

// Pack a byte stream into field elements: (MODULUS_BIT_SIZE - 1) / 8-byte
// little-endian chunks (ark-ff ToConstraintField semantics), emitted as
// 32-byte LE canonical values.  Returns the element count.
int64_t pack_bytes_to_elements(const uint8_t* in, int64_t nbytes,
                               int64_t chunk, uint8_t* out) {
  int64_t n = (nbytes + chunk - 1) / chunk;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = i * chunk;
    int64_t len = nbytes - lo < chunk ? nbytes - lo : chunk;
    std::memset(out + i * 32, 0, 32);
    std::memcpy(out + i * 32, in + lo, (size_t)len);
  }
  return n;
}

}  // extern "C"
