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
// What bounds it: each step is two 16-byte random reads (the ranks of l and
// u) that depend on the previous step, so a query is a chain of dependent
// HBM reads and the kernel is bound by their latency.  One thread per query
// keeps as many independent chains in flight as the batch has queries; a
// thread stops at its first empty interval.
//
// Output: half-open (l, u) per query, with empty intervals as the canonical
// (0, 0) — the same bits as the plain torch forms in ops/search.py.
//
// Input guard: every column a query's search reads must hold a code 1..4,
// and a masked query's length must lie in [1, K].  A query that breaks this
// reads no table, writes (0, 0) and adds one to *bad, which the wrapper
// turns into an error; so no input sends a read outside a table.

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

struct Layout {
  long long rows_per_symbol;
  int log2_block;
  int words_per_block;
  int row_words;
};

__device__ __forceinline__ void step(const uint32_t* __restrict__ table,
                                     int32_t start, int code, const Layout& g,
                                     int32_t& l, int32_t& u) {
  const int32_t nl = start + rs::occ_row(table, code, l, g.rows_per_symbol,
                                         g.log2_block, g.words_per_block,
                                         g.row_words);
  const int32_t nu = start + rs::occ_row(table, code, u, g.rows_per_symbol,
                                         g.log2_block, g.words_per_block,
                                         g.row_words);
  l = nl;
  u = nu;
}

// True when columns [from, K) of q all hold a base code 1..4.
__device__ __forceinline__ bool codes_ok(const int32_t* q, int from, int K) {
  for (int j = from; j < K; ++j) {
    if (static_cast<unsigned>(q[j] - 1) > 3u) return false;
  }
  return true;
}

// codes: int32 [B, K], right-aligned base codes 1..4, 0 padding on the left.
// kstep == 0: masked 1-step search over columns < r where r is K - p with a
//   LUT and K - 1 without; column j is active while j >= K - lengths[b].
// kstep != 0: every query has length K; triples (when rank3_rows is given),
//   then pairs, then one single step.
__global__ void backward_search_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    long long B, int K, const int32_t* __restrict__ C,
    const uint32_t* __restrict__ rank_rows, const int32_t* __restrict__ lut,
    int p, const uint32_t* __restrict__ rank2_rows,
    const int32_t* __restrict__ C2, const uint32_t* __restrict__ rank3_rows,
    const int32_t* __restrict__ C3, int kstep, Layout g,
    int32_t* __restrict__ out_l, int32_t* __restrict__ out_u,
    int32_t* __restrict__ bad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       b < B; b += stride) {
    const int32_t* q = codes + b * K;
    int from = 0;  // first column the search reads
    bool ok = true;
    if (!kstep) {
      const int len = lengths[b];
      ok = len >= 1 && len <= K;
      from = K - len;
      if (lut != nullptr && K - p < from) from = K - p;
    }
    if (!ok || !codes_ok(q, from, K)) {
      atomicAdd(bad, 1);
      out_l[b] = 0;
      out_u[b] = 0;
      continue;
    }
    int32_t l, u;
    int r;
    if (lut != nullptr) {
      int32_t id = 0;  // first character most significant (ops/search.py)
      for (int t = K - p; t < K; ++t) id = id * 4 + (q[t] - 1);
      const int2 lu = __ldg(reinterpret_cast<const int2*>(lut) + id);
      l = lu.x;
      u = lu.y;
      r = K - p;
    } else {
      const int c = q[K - 1];  // first step is free: occ(c, 0), occ(c, n)
      l = __ldg(C + c);
      u = __ldg(C + c + 1);
      r = K - 1;
    }
    if (kstep) {
      const int ntriples = rank3_rows != nullptr ? r / 3 : 0;
      const int rem = r - 3 * ntriples;
      for (int j = r - 3; j >= rem && l < u; j -= 3) {
        const int code = (q[j] - 1) * 16 + (q[j + 1] - 1) * 4 + (q[j + 2] - 1);
        step(rank3_rows, __ldg(C3 + code), code, g, l, u);
      }
      for (int j = rem - 2; j >= (rem & 1) && l < u; j -= 2) {
        const int code = (q[j] - 1) * 4 + (q[j + 1] - 1);
        step(rank2_rows, __ldg(C2 + code), code, g, l, u);
      }
      if ((rem & 1) && l < u) {
        const int c = q[0];
        step(rank_rows, __ldg(C + c), c, g, l, u);
      }
    } else {
      const int first = K - lengths[b];
      for (int j = r - 1; j >= first && l < u; --j) {
        const int c = q[j];
        step(rank_rows, __ldg(C + c), c, g, l, u);
      }
    }
    if (l >= u) {  // canonical empty interval
      l = 0;
      u = 0;
    }
    out_l[b] = l;
    out_u[b] = u;
  }
}

}  // namespace

extern "C" int rs_backward_search(
    const void* codes, const void* lengths, long long B, int K, const void* C,
    const void* rank_rows, const void* lut, int p, const void* rank2_rows,
    const void* C2, const void* rank3_rows, const void* C3, int kstep,
    long long rows_per_symbol, int log2_block, int words_per_block,
    int row_words, void* out_l, void* out_u, void* bad, void* stream) {
  if (B <= 0) return 0;
  const Layout g{rows_per_symbol, log2_block, words_per_block, row_words};
  const int threads = 128;
  long long blocks = (B + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  backward_search_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(lengths),
      B, K, static_cast<const int32_t*>(C),
      static_cast<const uint32_t*>(rank_rows),
      static_cast<const int32_t*>(lut), p,
      static_cast<const uint32_t*>(rank2_rows),
      static_cast<const int32_t*>(C2),
      static_cast<const uint32_t*>(rank3_rows),
      static_cast<const int32_t*>(C3), kstep, g,
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_u),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
