// K2: backward search, one thread per query through all of its steps.
//
// Replaces the XLA loops of readserver_tpu/ops/search.py: _scan_steps
// (lines 93-145, the masked 1-step search behind backward_search and
// backward_search_lut) and backward_search_pair (lines 220-337, the k-step
// schedule: optional LUT start, triples over rank3_rows/C3, then one pair
// over rank2_rows/C2, then one single step at the left edge).  The JAX
// package advances the whole batch one step per XLA gather and cannot fuse
// across steps (kernels/pallas_rank.py:23-27); here one thread carries one
// query from its start interval to its answer with (l, u) in registers.
//
// The body, the design that keeps the chain of dependent row reads short
// (TMA-staged codes packed to 2 bits in registers, blocks of 32 queries),
// and the k-step schedule are search.cuh's, shared with the sharded
// search; this file is its rank accessor over one index, whose steps issue
// their two row loads back to back (rs::occ_pair).  Block sizes 32 to 256
// timed within 3% of each other at widths 8192 and 262,144.
//
// The guard count goes to *bad on the card; the wrapper decides whether to
// wait for it (the engine reads it with its one result copy).

#include <climits>
#include <cuda_runtime.h>

#include "rank.cuh"
#include "search.cuh"

namespace {

// The rank accessor over one index (rank.cuh's layout): int32 intervals.
struct MonoRank {
  using Pos = int32_t;
  const int32_t* C;
  const uint32_t* rank_rows;
  const int32_t* lut_rows;
  const uint32_t* rank2_rows;
  const int32_t* C2;
  const uint32_t* rank3_rows;
  const int32_t* C3;
  rs::Layout g;

  __device__ __forceinline__ void lut(int32_t id, Pos& l, Pos& u) const {
    const int2 lu = __ldg(reinterpret_cast<const int2*>(lut_rows) + id);
    l = lu.x;
    u = lu.y;
  }

  __device__ __forceinline__ void start(int c, Pos& l, Pos& u) const {
    l = __ldg(C + c);
    u = __ldg(C + c + 1);
  }

  template <int K>
  __device__ __forceinline__ void step(rs::Cols<K>, int code, Pos& l,
                                       Pos& u) const {
    const uint32_t* table = K == 3 ? rank3_rows : (K == 2 ? rank2_rows : rank_rows);
    const int32_t* starts = K == 3 ? C3 : (K == 2 ? C2 : C);
    int32_t ol, ou;
    rs::occ_pair(table, table, code, l, u, g, ol, ou);
    const int32_t base = __ldg(starts + code);
    l = base + ol;
    u = base + ou;
  }
};

// ks: 0 the masked search, 2 pairs, 3 triples (see rs::search_block).
// Dynamic shared memory: rs::search_smem(K).
template <int NW>
__global__ void __launch_bounds__(rs::kSearchThreads) backward_search_kernel(
    MonoRank a, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ lengths, long long B, int K, int p, int ks,
    int32_t* __restrict__ out_l, int32_t* __restrict__ out_u,
    int32_t* __restrict__ bad) {
  extern __shared__ __align__(16) int32_t tile[];
  __shared__ __align__(8) uint64_t bar;
  rs::search_block<NW>(a, codes, lengths, B, K, p, ks, out_l, out_u, bad,
                       tile, &bar);
}

template <int NW>
int launch(const MonoRank& a, const void* codes, const void* lengths,
           long long B, int K, int p, int ks, void* out_l, void* out_u,
           void* bad, long long blocks, cudaStream_t stream) {
  backward_search_kernel<NW><<<static_cast<unsigned>(blocks),
                               rs::kSearchThreads, rs::search_smem(K),
                               stream>>>(
      a, static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(lengths), B, K, p, ks,
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_u),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K in [1, 256].  kstep == 0: the masked 1-step search over columns < r
// (r = K - p with a LUT, K - 1 without), column j active while
// j >= K - lengths[b]; kstep != 0: every query has length K, triples (when
// rank3_rows is given), then pairs, then one single step.
extern "C" int rs_backward_search(
    const void* codes, const void* lengths, long long B, int K, const void* C,
    const void* rank_rows, const void* lut, int p, const void* rank2_rows,
    const void* C2, const void* rank3_rows, const void* C3, int kstep,
    long long rows_per_symbol, int log2_block, int words_per_block,
    int row_words, void* out_l, void* out_u, void* bad, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + rs::kSearchThreads - 1) / rs::kSearchThreads;
  if (K < 1 || K > rs::kSearchMaxK || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MonoRank a{static_cast<const int32_t*>(C),
                   static_cast<const uint32_t*>(rank_rows),
                   static_cast<const int32_t*>(lut),
                   static_cast<const uint32_t*>(rank2_rows),
                   static_cast<const int32_t*>(C2),
                   static_cast<const uint32_t*>(rank3_rows),
                   static_cast<const int32_t*>(C3),
                   rs::Layout{rows_per_symbol, log2_block, words_per_block,
                              row_words}};
  const int pp = lut != nullptr ? p : 0;
  const int ks = kstep ? (rank3_rows != nullptr ? 3 : 2) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_LAUNCH(NW) \
  launch<NW>(a, codes, lengths, B, K, pp, ks, out_l, out_u, bad, blocks, s)
  if (K <= 32) return RS_LAUNCH(1);
  if (K <= 64) return RS_LAUNCH(2);
  if (K <= 128) return RS_LAUNCH(4);
  return RS_LAUNCH(8);
#undef RS_LAUNCH
}
