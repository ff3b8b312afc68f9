// Kernel 1's launch interface shared by its two bodies: the limb body
// (poseidon_opt.cu) and the two-word body at Goldilocks
// (poseidon_opt_words.cu).  Both read the same (t, L, B) plane of canonical
// Montgomery limbs and do the same rate I/O.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sponge {

// A launch's rate I/O (ops/poseidon_opt.py absorb_permute_opt).  rows[v]:
// up to two (k, L, B) views (null: absent), element v * k + r of them added
// into state row lo + v * k + r; each view is read through its own element
// strides (row, limb, lane), so the even and odd lanes of a Merkle level
// are two views of it with lane stride 2.  fresh: the state is zero and
// ``in`` is not read.  Rows [out_lo, out_hi) of the permuted state are
// stored, as an (out_hi - out_lo, L, B) plane.  No rows, not fresh and rows
// [0, t) is the plain permutation.
struct RateIO {
  const int32_t* rows[2];
  long long stride[2][3];
  int k, lo, fresh, out_lo, out_hi;
};

// Kernel 1's two-word body (poseidon_opt_words.cu) at t, reading its word
// constant buffer ``words`` of ``n_words`` int32 (ops/poseidon_opt.py
// word_constants); -1 where it has no instantiation at (t, L) or the buffer
// has another length.
int launch_opt_words(const int32_t* in, int32_t* out, long long B, int t, int L, int alpha, int full_rounds,
                     int partial_rounds, const int32_t* words, int n_words, const RateIO& io, cudaStream_t stream);

}  // namespace sponge
