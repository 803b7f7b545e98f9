// K14 and K15: the row-budget compaction of the resolve and the capped
// per-sample histogram.
//
// Replace the XLA ops of readserver_tpu/ops/resolve.py, which the JAX package
// never wrote in Pallas:
//   K14 rs_row_compact, rs_row_gather
//                 expand_intervals (74-88) and the row-budget compaction of
//                 resolve_intervals (383-413): a cumsum over the B*H lanes,
//                 three scatters into the budget and two scatters back;
//   K15 rs_capped_histogram
//                 sample_histogram (502-519), and its copy in the doc-sharded
//                 body (parallel/doc_sharded.py:272-283): a gather of each hit
//                 lane's sample and a segment_sum into [B, S].
//
// K14.  Lane (b, h) of the [B, H] expansion holds SA row l[b] + h where
// h < u[b] - l[b]; the first R_c valid lanes in flat order walk.  The lanes a
// query contributes are c_b = min(max(u_b - l_b, 0), H), so the flat
// position of lane (b, h) among the valid lanes is P_b + h, P the exclusive
// prefix of c.  rs_row_compact scans c in one block (B is a batch width, a
// few thousand), then fills each of the R_c slots from its query, found by a
// binary search of P: slot g < min(total, R_c) holds row l[q] + g - P_q, the
// rest row 0 and invalid.  After the walk, rs_row_gather reads each lane's
// answer back from slot P_b + h, -1 where the lane is invalid or past the
// budget: a gather, so nothing is scattered and no slot keeps its lane's
// index.  Bytes bound both: the intervals and the prefix are read, the
// budget's rows and flags written, then the budget's answers read and the
// [B, H] answers written.
//
// K15.  Each block counts the valid lanes of a run of queries into a
// shared-memory histogram of [queries, S] int32 by integer atomics (exact,
// whatever their order), then writes the rows whole; where S leaves no room
// for one query's row in shared memory, the lanes add into the zeroed output
// by global atomics.  A lane's sample is read_to_sample[clip(rid, 0,
// num_reads - 1)], so a valid lane whose walk gave -1 counts under
// read_to_sample[0], as the reference's clip does.  Bytes bound it: the hit
// lanes and flags read, a sample read a valid lane, the histogram written.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 1024;  // the one block of the prefix scan
constexpr int kThreads = 256;
constexpr int kHistSmemInts = 12 * 1024;  // 48 KB of static shared memory
constexpr int kHistMaxQueries = 32;       // queries a histogram block takes

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

__device__ __forceinline__ int32_t lanes_of(const int32_t* __restrict__ l,
                                            const int32_t* __restrict__ u,
                                            long long b, int H) {
  const int32_t n = u[b] - l[b];
  return n < 0 ? 0 : (n > H ? H : n);
}

// prefix[b] = sum of lanes_of over queries < b, for b = 0..B (prefix[B] is
// the total): each thread sums a contiguous run of queries, the block scans
// the runs' sums, then each thread writes its run's prefixes.
__global__ void __launch_bounds__(kScanThreads)
    compact_scan_kernel(const int32_t* __restrict__ l,
                    const int32_t* __restrict__ u, long long B, int H,
                    int32_t* __restrict__ prefix) {
  __shared__ int32_t part[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (B + kScanThreads - 1) / kScanThreads;
  const long long a = per * t < B ? per * t : B;
  const long long e = a + per < B ? a + per : B;
  int32_t sum = 0;
  for (long long b = a; b < e; ++b) sum += lanes_of(l, u, b, H);
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const int32_t add = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  int32_t run = part[t] - sum;
  for (long long b = a; b < e; ++b) {
    prefix[b] = run;
    run += lanes_of(l, u, b, H);
  }
  if (t == kScanThreads - 1) prefix[B] = part[t];
}

// Slot g of the budget: the query q whose lanes hold flat position g (the
// last q with prefix[q] <= g; empty queries repeat their prefix) and its
// row, or row 0 and invalid past the total.
__global__ void __launch_bounds__(kThreads)
    compact_slot_kernel(const int32_t* __restrict__ l,
                    const int32_t* __restrict__ prefix, long long B,
                    long long R_c, int32_t* __restrict__ rows,
                    uint8_t* __restrict__ valid) {
  const long long total = prefix[B];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < R_c; g += stride) {
    if (g < total) {
      long long lo = 0, hi = B - 1;  // prefix[lo] <= g throughout
      while (lo < hi) {
        const long long mid = (lo + hi + 1) >> 1;
        if (prefix[mid] <= g) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      rows[g] = l[lo] + static_cast<int32_t>(g - prefix[lo]);
      valid[g] = 1;
    } else {
      rows[g] = 0;
      valid[g] = 0;
    }
  }
}

// Lane (b, h) of [B, H]: the walk's answer in slot prefix[b] + h where the
// lane is valid and inside the budget, else -1 and invalid.
__global__ void __launch_bounds__(kThreads)
    compact_gather_kernel(const int32_t* __restrict__ l,
                      const int32_t* __restrict__ u,
                      const int32_t* __restrict__ prefix, long long B, int H,
                      long long R_c, const int32_t* __restrict__ rid_c,
                      const int32_t* __restrict__ off_c,
                      int32_t* __restrict__ rid, int32_t* __restrict__ off,
                      uint8_t* __restrict__ valid) {
  const long long F = B * H;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < F; i += stride) {
    const long long b = i / H;
    const int h = static_cast<int>(i - b * H);
    const long long p = static_cast<long long>(prefix[b]) + h;
    const bool keep = h < u[b] - l[b] && p < R_c;
    rid[i] = keep ? rid_c[p] : -1;
    off[i] = keep ? off_c[p] : -1;
    valid[i] = keep ? 1 : 0;
  }
}

__device__ __forceinline__ int sample_of(const int32_t* __restrict__ r2s,
                                         long long num_reads, int32_t r) {
  const long long c = r < 0 ? 0 : (r >= num_reads ? num_reads - 1 : r);
  return r2s[c];
}

// Runs of qpb queries, a run a block at a time: its lanes into a shared
// [nq, S] histogram, then its rows written whole.
__global__ void __launch_bounds__(kThreads)
    capped_hist_kernel(const int32_t* __restrict__ rid,
                       const uint8_t* __restrict__ valid, long long B, int H,
                       const int32_t* __restrict__ r2s, long long num_reads,
                       int S, int qpb, int32_t* __restrict__ hist) {
  __shared__ int32_t cells[kHistSmemInts];
  for (long long q0 = static_cast<long long>(blockIdx.x) * qpb; q0 < B;
       q0 += static_cast<long long>(gridDim.x) * qpb) {
    const int nq = static_cast<int>(B - q0 < qpb ? B - q0 : qpb);
    for (int i = threadIdx.x; i < nq * S; i += blockDim.x) cells[i] = 0;
    __syncthreads();
    const long long lane0 = q0 * H;
    for (int i = threadIdx.x; i < nq * H; i += blockDim.x) {
      if (valid[lane0 + i]) {
        const int s = sample_of(r2s, num_reads, rid[lane0 + i]);
        if (static_cast<unsigned>(s) < static_cast<unsigned>(S)) {
          atomicAdd(&cells[(i / H) * S + s], 1);
        }
      }
    }
    __syncthreads();
    int32_t* out = hist + q0 * S;
    for (int i = threadIdx.x; i < nq * S; i += blockDim.x) out[i] = cells[i];
    __syncthreads();
  }
}

// The same counts by global atomics into a zeroed [B, S], for an S whose
// row does not fit the shared histogram.
__global__ void __launch_bounds__(kThreads)
    capped_hist_global_kernel(const int32_t* __restrict__ rid,
                              const uint8_t* __restrict__ valid, long long B,
                              int H, const int32_t* __restrict__ r2s,
                              long long num_reads, int S,
                              int32_t* __restrict__ hist) {
  const long long F = B * H;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < F; i += stride) {
    if (valid[i]) {
      const int s = sample_of(r2s, num_reads, rid[i]);
      if (static_cast<unsigned>(s) < static_cast<unsigned>(S)) {
        atomicAdd(&hist[(i / H) * S + s], 1);
      }
    }
  }
}

}  // namespace

// K14, before the walk: the exclusive prefix of each query's lanes
// (prefix, int32 [B + 1]) and the budget's R_c slots (rows int32, valid
// uint8), in two launches.
extern "C" int rs_row_compact(const void* l, const void* u, long long B, int H,
                              long long R_c, void* prefix, void* rows,
                              void* valid, void* stream) {
  if (B < 0 || H < 1 || R_c < 0 || B * H >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l32 = static_cast<const int32_t*>(l);
  auto* p32 = static_cast<int32_t*>(prefix);
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>(
      l32, static_cast<const int32_t*>(u), B, H, p32);
  if (R_c > 0) {
    compact_slot_kernel<<<grid_for(R_c, kThreads), kThreads, 0, st>>>(
        l32, p32, B, R_c, static_cast<int32_t*>(rows),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}

// K14, after the walk: the budget's answers (rid_c, off_c [R_c]) back to the
// [B, H] lanes (rid, off int32, valid uint8).
extern "C" int rs_row_gather(const void* l, const void* u, long long B, int H,
                             long long R_c, const void* prefix,
                             const void* rid_c, const void* off_c, void* rid,
                             void* off, void* valid, void* stream) {
  if (B < 0 || H < 1 || R_c < 0 || B * H >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  compact_gather_kernel<<<grid_for(B * H, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(u),
      static_cast<const int32_t*>(prefix), B, H, R_c,
      static_cast<const int32_t*>(rid_c), static_cast<const int32_t*>(off_c),
      static_cast<int32_t*>(rid), static_cast<int32_t*>(off),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// K15: hist int32 [B, S] of the valid lanes of rid [B, H] (valid uint8) by
// sample.
extern "C" int rs_capped_histogram(const void* rid, const void* valid,
                                   long long B, int H,
                                   const void* read_to_sample,
                                   long long num_reads, int S, void* hist,
                                   void* stream) {
  if (B < 0 || H < 1 || S < 1 || num_reads < 1 || B * H >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rid);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* r2s = static_cast<const int32_t*>(read_to_sample);
  auto* h = static_cast<int32_t*>(hist);
  if (S <= kHistSmemInts) {
    int qpb = kHistSmemInts / S;
    if (qpb > kHistMaxQueries) qpb = kHistMaxQueries;
    capped_hist_kernel<<<grid_for(B, qpb), kThreads, 0, st>>>(
        r, v, B, H, r2s, num_reads, S, qpb, h);
  } else {
    cudaMemsetAsync(h, 0, static_cast<size_t>(B) * S * sizeof(int32_t), st);
    capped_hist_global_kernel<<<grid_for(B * H, kThreads), kThreads, 0, st>>>(
        r, v, B, H, r2s, num_reads, S, h);
  }
  return static_cast<int>(cudaGetLastError());
}
