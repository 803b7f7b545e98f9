// K1: batched rank, occ(c[b], i[b]) for every b.
//
// Replaces readserver_tpu/kernels/pallas_rank.py::_rank_kernel (the Pallas
// kernel, pallas_call at line 144), which the JAX package served as the XLA
// row gather of readserver_tpu/ops/rank.py::occ_rows.  The TPU kernel staged
// 128 rows per grid step through pipelined single-row DMAs; on Hopper each
// thread fetches its own row with one 16-byte load and popcounts it in
// registers.
//
// What bounds it: one dependent-free random 16-byte read per rank from a
// table far larger than L2, so it is bound by the rate of random sector
// reads from HBM, and by latency when B is small.  The design keeps every
// thread to exactly one row load and launches enough threads to keep many
// loads in flight; nothing is staged in shared memory.
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
                                long long rows_per_symbol, int log2_block,
                                int words_per_block, int row_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       b < B; b += stride) {
    out[b] = rs::occ_row(table, c[b], i[b], rows_per_symbol, log2_block,
                         words_per_block, row_words);
  }
}

}  // namespace

extern "C" int rs_rank_occ(const void* table, const void* c, const void* i,
                           void* out, long long B, long long rows_per_symbol,
                           int log2_block, int words_per_block, int row_words,
                           void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  long long blocks = (B + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  rank_occ_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(i), static_cast<int32_t*>(out), B,
      rows_per_symbol, log2_block, words_per_block, row_words);
  return static_cast<int>(cudaGetLastError());
}
