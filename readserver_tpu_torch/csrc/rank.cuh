// occ(c, i) on the fused rank-block layout, one thread's worth.
//
// The table is uint32 [P * rows_per_symbol, row_words]; row
// c * rows_per_symbol + (i >> log2_block) holds
// [checkpoint, plane words..., padding], and occ(c, i) is the checkpoint plus
// the popcount of the plane words masked to the first i & (block - 1) bits
// (index/packing.py).  Shared by the rank kernels (rank.cu), the search
// (search.cu, search.cuh), the walks (walk.cuh) and the sharded kernels
// (sharded.cu), so all of them give the same answer bit for bit.
#pragma once

#include <cstddef>
#include <cstdint>

namespace rs {

// The table's shape, as the kernels take it.
struct Layout {
  long long rows_per_symbol;
  int log2_block;
  int words_per_block;
  int row_words;
};

// Low `bits` bits set, bits in [0, 32].  (1u << 32) is undefined, so the
// full word takes its own branch (ops/rank.py builds it with a where).
__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__device__ __forceinline__ int clamp_bits(int v) {
  return v < 0 ? 0 : (v > 32 ? 32 : v);
}

// The row's first word.  The row offset is computed in size_t: for the
// 64-plane triple table of a chr20-sized index the word offset passes 2^31.
__device__ __forceinline__ const uint32_t* row_ptr(
    const uint32_t* __restrict__ table, int c, int32_t block,
    const Layout& g) {
  const size_t row =
      static_cast<size_t>(c) * static_cast<size_t>(g.rows_per_symbol) +
      static_cast<size_t>(block);
  return table + row * static_cast<size_t>(g.row_words);
}

// occ within a 16-byte row [checkpoint, w0, w1, w2] loaded in registers.
__device__ __forceinline__ int32_t count_row4(const uint4& v, int within,
                                              int words_per_block) {
  const uint32_t w[3] = {v.y, v.z, v.w};
  uint32_t acc = v.x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < words_per_block) {
      acc += __popc(w[k] & low_mask(clamp_bits(within - 32 * k)));
    }
  }
  return static_cast<int32_t>(acc);
}

// occ within a row of any width, read word by word.
__device__ __forceinline__ int32_t count_row(const uint32_t* __restrict__ r,
                                             int within, int words_per_block) {
  uint32_t acc = __ldg(r);
  for (int k = 0; k < words_per_block; ++k) {
    acc += __popc(__ldg(r + 1 + k) & low_mask(clamp_bits(within - 32 * k)));
  }
  return static_cast<int32_t>(acc);
}

// One rank: one 16-byte load of the row when row_words == 4 (the default
// layout: checkpoint + 2 plane words + pad), a word loop otherwise.
__device__ __forceinline__ int32_t occ_row(const uint32_t* __restrict__ table,
                                           int c, int32_t i, const Layout& g) {
  const int32_t block = i >> g.log2_block;
  const int within = i - (block << g.log2_block);
  const uint32_t* r = row_ptr(table, c, block, g);
  if (g.row_words == 4) {
    return count_row4(__ldg(reinterpret_cast<const uint4*>(r)), within,
                      g.words_per_block);
  }
  return count_row(r, within, g.words_per_block);
}

// The two ranks of one interval step, occ(c, l) in table tl and occ(c, u)
// in table tu (one table, or two shards of one), their two independent row
// loads issued back to back.  (Loading the row once when l and u fall in
// one rank block measured slower on the H100, PERF.md: the second load then
// waits on the comparison, and a repeated address costs the memory system
// little.)
__device__ __forceinline__ void occ_pair(const uint32_t* __restrict__ tl,
                                         const uint32_t* __restrict__ tu,
                                         int c, int32_t l, int32_t u,
                                         const Layout& g, int32_t& ol,
                                         int32_t& ou) {
  const int32_t bl = l >> g.log2_block;
  const int32_t bu = u >> g.log2_block;
  const int wl = l - (bl << g.log2_block);
  const int wu = u - (bu << g.log2_block);
  if (g.row_words == 4) {
    const uint4 rl = __ldg(reinterpret_cast<const uint4*>(row_ptr(tl, c, bl, g)));
    const uint4 ru = __ldg(reinterpret_cast<const uint4*>(row_ptr(tu, c, bu, g)));
    ol = count_row4(rl, wl, g.words_per_block);
    ou = count_row4(ru, wu, g.words_per_block);
  } else {
    ol = count_row(row_ptr(tl, c, bl, g), wl, g.words_per_block);
    ou = count_row(row_ptr(tu, c, bu, g), wu, g.words_per_block);
  }
}

}  // namespace rs
