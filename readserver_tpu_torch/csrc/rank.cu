// K1: batched rank, occ(c[b], i[b]) for every b, and its prefix-LUT level
// entry.
//
// Replaces readserver_tpu/kernels/pallas_rank.py::_rank_kernel (the Pallas
// kernel, pallas_call at line 144), which the JAX package served as the XLA
// row gather of readserver_tpu/ops/rank.py::occ_rows.  The TPU kernel staged
// 128 rows per grid step through pipelined single-row DMAs; on Hopper each
// thread fetches its own row with one 16-byte load and popcounts it in
// registers.
//
// rs_rank_occ (the generic entry, counterpart of occ_pallas_rows): one
// dependent-free random 16-byte read per rank from a table far larger than
// L2, so it is bound by the rate of random sector reads from HBM, and by
// latency when B is small.  Each thread does exactly one row load; nothing
// is staged in shared memory.
//
// rs_lut_level (the prefix-LUT build, readserver_tpu/ops/lut.py::
// _extend_level with K1 as its rank): level l's S intervals → level l+1's
// 4S in c-major order, entry (c-1)*stride + s = C[c] + occ(c, l_s),
// C[c] + occ(c, u_s), frozen where l_s >= u_s.  One thread per interval
// reads it once and issues its (up to) eight row loads back to back
// (rs::occ_pair).  The level's intervals are in lexicographic order, so l_s
// grows with s and neighbouring threads read neighbouring rows of each
// c-block.  The last level writes
// the LUT's (l, u) pairs with empties as (0, 0), so the build makes no
// temporaries.  Bound by the bytes it must move: 8 B in and 32 B out per
// interval plus the distinct rows it touches.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

__global__ void rank_occ_kernel(const uint32_t* __restrict__ table,
                                const int32_t* __restrict__ c,
                                const int32_t* __restrict__ i,
                                int32_t* __restrict__ out, long long B,
                                rs::Layout g) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       b < B; b += stride) {
    out[b] = rs::occ_row(table, c[b], i[b], g);
  }
}

// out_pairs != nullptr: the last level, written as int2 (l, u) pairs with
// empties canonical; else out_l / out_u.  Entry (c-1)*stride + s.
__global__ void lut_level_kernel(const uint32_t* __restrict__ table,
                                 const int32_t* __restrict__ C,
                                 const int32_t* __restrict__ l_in,
                                 const int32_t* __restrict__ u_in, long long S,
                                 int32_t* __restrict__ out_l,
                                 int32_t* __restrict__ out_u,
                                 int2* __restrict__ out_pairs,
                                 long long stride, rs::Layout g) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < S; s += step) {
    const int32_t l = l_in[s];
    const int32_t u = u_in[s];
    const bool alive = l < u;
    int32_t nl[4], nu[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nl[k] = l;
      nu[k] = u;
      if (alive) {
        const int32_t base = __ldg(C + k + 1);
        rs::occ_pair(table, table, k + 1, l, u, g, nl[k], nu[k]);
        nl[k] += base;
        nu[k] += base;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long e = k * stride + s;
      if (out_pairs != nullptr) {
        out_pairs[e] = nl[k] < nu[k] ? make_int2(nl[k], nu[k])
                                     : make_int2(0, 0);
      } else {
        out_l[e] = nl[k];
        out_u[e] = nu[k];
      }
    }
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int rs_rank_occ(const void* table, const void* c, const void* i,
                           void* out, long long B, long long rows_per_symbol,
                           int log2_block, int words_per_block, int row_words,
                           void* stream) {
  if (B <= 0) return 0;
  const rs::Layout g{rows_per_symbol, log2_block, words_per_block, row_words};
  const int threads = 256;
  rank_occ_kernel<<<grid_for(B, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(i), static_cast<int32_t*>(out), B, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_lut_level(const void* table, const void* C, const void* l,
                            const void* u, long long S, void* out_l,
                            void* out_u, void* out_pairs, long long stride,
                            long long rows_per_symbol, int log2_block,
                            int words_per_block, int row_words, void* stream) {
  if (S <= 0) return 0;
  const rs::Layout g{rows_per_symbol, log2_block, words_per_block, row_words};
  const int threads = 256;
  lut_level_kernel<<<grid_for(S, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(C),
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(u), S,
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_u),
      static_cast<int2*>(out_pairs), stride, g);
  return static_cast<int>(cudaGetLastError());
}
