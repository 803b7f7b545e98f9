// occ(c, i) on the fused rank-block layout, one thread's worth.
//
// The table is uint32 [P * rows_per_symbol, row_words]; row
// c * rows_per_symbol + (i >> log2_block) holds
// [checkpoint, plane words..., padding], and occ(c, i) is the checkpoint plus
// the popcount of the plane words masked to the first i & (block - 1) bits
// (index/packing.py).  Shared by the rank kernel (rank.cu) and the search
// kernel (search.cu), so both give the same answer bit for bit.
#pragma once

#include <cstddef>
#include <cstdint>

namespace rs {

// Low `bits` bits set, bits in [0, 32].  (1u << 32) is undefined, so the
// full word takes its own branch (ops/rank.py builds it with a where).
__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__device__ __forceinline__ int clamp_bits(int v) {
  return v < 0 ? 0 : (v > 32 ? 32 : v);
}

// One rank: one 16-byte load of the row when row_words == 4 (the default
// layout: checkpoint + 2 plane words + pad), a word loop otherwise.  The row
// offset is computed in size_t: for the 64-plane triple table of a
// chr20-sized index the word offset passes 2^31.
__device__ __forceinline__ int32_t occ_row(
    const uint32_t* __restrict__ table, int c, int32_t i,
    long long rows_per_symbol, int log2_block, int words_per_block,
    int row_words) {
  const int32_t block = i >> log2_block;
  const int within = i - (block << log2_block);
  const size_t row =
      static_cast<size_t>(c) * static_cast<size_t>(rows_per_symbol) +
      static_cast<size_t>(block);
  const uint32_t* r = table + row * static_cast<size_t>(row_words);
  uint32_t acc;
  if (row_words == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(r));
    const uint32_t w[3] = {v.y, v.z, v.w};
    acc = v.x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < words_per_block) {
        acc += __popc(w[k] & low_mask(clamp_bits(within - 32 * k)));
      }
    }
  } else {
    acc = __ldg(r);
    for (int k = 0; k < words_per_block; ++k) {
      acc += __popc(__ldg(r + 1 + k) & low_mask(clamp_bits(within - 32 * k)));
    }
  }
  return static_cast<int32_t>(acc);
}

}  // namespace rs
