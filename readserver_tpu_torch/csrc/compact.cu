// K14 and K15: the row-budget compaction of the resolve and the capped
// per-sample histogram.
//
// Replace the XLA ops of readserver_tpu/ops/resolve.py, which the JAX package
// never wrote in Pallas:
//   K14 rs_row_compact, rs_row_gather
//                 expand_intervals (74-88) and the row-budget compaction of
//                 resolve_intervals (383-413), and its copy in the
//                 interval-sharded _query_body (parallel/sharded.py:902-929):
//                 a cumsum over the B*H lanes, three scatters into the
//                 budget and two or three scatters back;
//   K15 rs_capped_histogram
//                 sample_histogram (502-519), its copy in the doc-sharded
//                 body (parallel/doc_sharded.py:272-283) and the capped
//                 histogram of _query_body (parallel/sharded.py:930-935): a
//                 gather of each hit lane's sample and a segment_sum into
//                 [B, S].
//
// K14.  Lane (b, h) of the [B, H] expansion holds SA row l[b] + h where
// h < u[b] - l[b]; the first R_c valid lanes in flat order walk.  The lanes a
// query contributes are c_b = min(max(u_b - l_b, 0), H), so the flat
// position of lane (b, h) among the valid lanes is P_b + h, P the exclusive
// prefix of c.  rs_row_compact is one launch and needs no wait across
// blocks: every block reads the batch's intervals in chunks of 8192
// queries, eight a thread as 16-byte vectors, scans their lane counts (a
// warp-shuffle scan, three barriers a chunk) and keeps the chunk's prefix
// and each query's row base l - P in shared memory, then fills its own
// stretch of 4096 slots: each thread finds the query of its first slot by
// a binary search of the prefix in shared memory and walks on through
// four consecutive slots, stored as one vector.  Slot g < min(total, R_c)
// holds row l[q] + g - P_q, the rest row 0 and invalid; block 0 also
// writes the prefix (int32 [B + 1], its last entry the total).  The batch
// is re-read by every block, from the L2 (8192 queries are 64 KB of int32
// intervals, 128 KB of int64): the price of needing no flags between
// blocks, whose reset a decoupled look-back would need.  Rows are int32
// (one device, doc shards) or int64 (the interval shards' global rows);
// the prefix stays int32, since B * H < 2^31.
// After the walk, rs_row_gather reads each lane's answer back from slot
// P_b + h, -1 where the lane is invalid or past the budget: a gather, so
// nothing is scattered and no slot keeps its lane's index.  Query b's
// lanes are P_{b+1} - P_b, so the gather reads the prefix and no
// interval.  Each thread takes four consecutive lanes (one 32-bit division
// for the four) and writes each column as one 16-byte vector and the
// flags as one word.  A third column, where asked: the walk's sample of
// the slot (0 where the lane drops: the interval programs) or
// read_to_sample[clip(rid, 0, num_reads - 1)] (-1 where the lane drops:
// the single-device hit step).
// Bytes bound both: the intervals read and the prefix written, with the
// budget's rows and flags, then the prefix and the budget's answers read
// and the [B, H] columns written.
//
// K15.  A warp a query, its S bins in the warp's own stretch of shared
// memory (no barrier of the block): the warp zeroes its bins, each pass of
// 32 lanes groups the lanes by sample (__match_any_sync) and the first of a
// group adds the group's size by one shared atomic, then the warp writes
// the row whole.  An S whose bins leave no room in shared memory adds into
// the query's row of the output, zeroed by the same warp first.  A lane's
// sample is read_to_sample[clip(rid, 0, num_reads - 1)], so a valid lane
// whose walk gave -1 counts under read_to_sample[0], as the reference's clip
// does; or, with no read_to_sample (the interval programs, whose walk gave
// each slot's sample), the lane's sample itself.  Bytes bound it: the hit
// lanes and flags read, a sample read a valid lane, the histogram written.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 1024;  // a compaction block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kChunk = 8192;        // queries a block scans at a time
constexpr int kPerThread = kChunk / kScanThreads;
constexpr int kSlotVec = 4;         // consecutive slots a thread fills
constexpr int kSlotsPerBlock = 4096;  // a block's stretch of the budget
static_assert(kPerThread % 8 == 0 && kSlotsPerBlock % kSlotVec == 0,
              "whole 16-byte vectors");
constexpr int kMaxCompactBlocks = 264;  // two a streaming multiprocessor
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHistSmemInts = 12 * 1024;  // 48 KB of shared bins a block

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

template <typename T>
__device__ __forceinline__ int lanes_of(T l, T u, int H) {
  const T n = u - l;
  return n <= 0 ? 0 : (n >= H ? H : static_cast<int>(n));
}

template <typename T>
struct Vec4;  // four rows as one store
template <>
struct Vec4<int32_t> {
  __device__ static void store(int32_t* p, const int32_t* r) {
    *reinterpret_cast<int4*>(p) = make_int4(r[0], r[1], r[2], r[3]);
  }
};
template <>
struct Vec4<int64_t> {
  __device__ static void store(int64_t* p, const int64_t* r) {
    auto* q = reinterpret_cast<longlong2*>(p);
    q[0] = make_longlong2(r[0], r[1]);
    q[1] = make_longlong2(r[2], r[3]);
  }
};

template <typename T>
struct Vec8;  // eight consecutive values as 16-byte loads and stores
template <>
struct Vec8<int32_t> {
  __device__ static void load(const int32_t* p, int32_t* v) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ static void store(int32_t* p, const int32_t* v) {
    reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
  }
};
template <>
struct Vec8<int64_t> {
  __device__ static void load(const int64_t* p, int64_t* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const longlong2 a = reinterpret_cast<const longlong2*>(p)[i];
      v[2 * i] = a.x, v[2 * i + 1] = a.y;
    }
  }
  __device__ static void store(int64_t* p, const int64_t* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      reinterpret_cast<longlong2*>(p)[i] = make_longlong2(v[2 * i],
                                                          v[2 * i + 1]);
    }
  }
};

__device__ __forceinline__ uint32_t pack4(const uint8_t* v) {
  return v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<uint32_t>(v[3])
                                              << 24);
}

// The exclusive prefix of v over the block's threads; ``total`` their sum.
// Two barriers; ``sums`` (32 ints) is free again after the next barrier.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanWarps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  total = sums[kScanWarps - 1];
  return (warp ? sums[warp - 1] : 0) + x - v;
}

// K14's compaction: block k fills slots [k * per_block, (k + 1) *
// per_block) of the R_c; block 0 also writes the prefix.  Each thread
// reads eight consecutive intervals as 16-byte vectors (l and u are
// 16-byte aligned); shared memory holds a chunk's exclusive prefix and
// each query's row base l - prefix, so a slot's row is one shared read.
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1)  // 64 registers: no spill
    row_compact_kernel(const T* __restrict__ l, const T* __restrict__ u,
                       int B, int H, int R_c, int per_block,
                       int32_t* __restrict__ prefix, T* __restrict__ rows,
                       uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  T* base = reinterpret_cast<T*>(chunk_smem);       // [kChunk]
  int* pre = reinterpret_cast<int*>(base + kChunk);  // [kChunk + 1]
  __shared__ int sums[32];
  const int t = threadIdx.x;
  const bool lead = blockIdx.x == 0;
  const int g0 = static_cast<int>(blockIdx.x) * per_block;
  const int g1 = R_c - g0 < per_block ? R_c : g0 + per_block;
  int carry = 0;  // valid lanes before the chunk
  for (int q0 = 0; q0 < B; q0 += kChunk) {
    const int n = B - q0 < kChunk ? B - q0 : kChunk;
    const int a = t * kPerThread;
    const bool whole = a + kPerThread <= n;
    T lv[kPerThread], uv[kPerThread];
    if (whole) {
#pragma unroll
      for (int j = 0; j < kPerThread; j += 8) {
        Vec8<T>::load(l + q0 + a + j, lv + j);
        Vec8<T>::load(u + q0 + a + j, uv + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        lv[j] = a + j < n ? l[q0 + a + j] : 0;
        uv[j] = a + j < n ? u[q0 + a + j] : 0;
      }
    }
    int c[kPerThread];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      c[j] = lanes_of(lv[j], uv[j], H);
      sum += c[j];
    }
    int total;
    int run = block_scan(sum, sums, total);
    int pv[kPerThread], gv[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      pv[j] = run;
      gv[j] = carry + run;
      lv[j] -= static_cast<T>(run);  // the row base
      run += c[j];
    }
    if (whole) {
#pragma unroll
      for (int j = 0; j < kPerThread; j += 8) {
        Vec8<int32_t>::store(pre + a + j, pv + j);
        Vec8<T>::store(base + a + j, lv + j);
        if (lead) Vec8<int32_t>::store(prefix + q0 + a + j, gv + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (a + j < n) {
          pre[a + j] = pv[j];
          base[a + j] = lv[j];
          if (lead) prefix[q0 + a + j] = gv[j];
        }
      }
    }
    if (t == 0) pre[n] = total;
    __syncthreads();
    // this block's slots among the chunk's lanes, four a thread from a
    // multiple of four: [s0, s1)
    const int s0 = g0 > carry ? g0 : carry;
    const int s1 = g1 < carry + total ? g1 : carry + total;
    for (int sb = (s0 & ~(kSlotVec - 1)) + kSlotVec * t; sb < s1;
         sb += kSlotVec * kScanThreads) {
      const int first = sb > s0 ? sb : s0;
      const int p = first - carry;
      int lo = 0, hi = n - 1;  // the last query with pre <= p
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= p) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      int q = lo;
      T r[kSlotVec];
#pragma unroll
      for (int k = 0; k < kSlotVec; ++k) {
        const int s = sb + k;
        r[k] = 0;
        if (s >= s0 && s < s1) {
          const int pk = s - carry;
          while (pre[q + 1] <= pk) ++q;  // pre[n] = total > pk
          r[k] = base[q] + static_cast<T>(pk);
        }
      }
      if (sb >= s0 && sb + kSlotVec <= s1) {
        Vec4<T>::store(rows + sb, r);
        *reinterpret_cast<uint32_t*>(valid + sb) = 0x01010101u;
      } else {
#pragma unroll
        for (int k = 0; k < kSlotVec; ++k) {
          if (sb + k >= s0 && sb + k < s1) {
            rows[sb + k] = r[k];
            valid[sb + k] = 1;
          }
        }
      }
    }
    carry += total;
    __syncthreads();  // pre, base and sums are the next chunk's
    if (!lead && carry >= g1) break;  // the same on every thread
  }
  for (int s = (g0 > carry ? g0 : carry) + t; s < g1; s += kScanThreads) {
    rows[s] = 0;
    valid[s] = 0;
  }
  if (lead && t == 0) prefix[B] = carry;
}

// the gather's third column
enum Column { kNone = 0, kSlotSample = 1, kReadSample = 2 };

// K14's gather: four consecutive lanes a thread; query b's lanes are
// prefix[b + 1] - prefix[b], so no interval is read.
template <int kCol>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const int32_t* __restrict__ prefix, int B, int H,
                      int R_c, const int32_t* __restrict__ rid_c,
                      const int32_t* __restrict__ off_c,
                      const int32_t* __restrict__ col, int num_reads,
                      int32_t* __restrict__ rid, int32_t* __restrict__ off,
                      int32_t* __restrict__ smp,
                      uint8_t* __restrict__ valid) {
  const unsigned F = static_cast<unsigned>(B) * static_cast<unsigned>(H);
  const unsigned stride = gridDim.x * blockDim.x * 4u;
  for (unsigned i0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4u; i0 < F;
       i0 += stride) {
    unsigned b = i0 / static_cast<unsigned>(H);
    int h = static_cast<int>(i0 - b * static_cast<unsigned>(H));
    int p0 = prefix[b];
    int n = prefix[b + 1] - p0;
    int32_t a[4], o[4], s[4];
    uint8_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (h == H) {
        h = 0;
        if (++b < static_cast<unsigned>(B)) {
          p0 = prefix[b];
          n = prefix[b + 1] - p0;
        }
      }
      const int p = p0 + h;
      const bool keep = i0 + k < F && h < n && p < R_c;
      a[k] = keep ? rid_c[p] : -1;
      o[k] = keep ? off_c[p] : -1;
      if (kCol == kSlotSample) {
        s[k] = keep ? col[p] : 0;
      } else if (kCol == kReadSample) {
        const int r = a[k] < 0 ? 0 : (a[k] >= num_reads ? num_reads - 1
                                                        : a[k]);
        s[k] = keep ? col[r] : -1;
      }
      v[k] = keep ? 1 : 0;
      ++h;
    }
    if (i0 + 4 <= F) {
      *reinterpret_cast<int4*>(rid + i0) = make_int4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<int4*>(off + i0) = make_int4(o[0], o[1], o[2], o[3]);
      if (kCol != kNone) {
        *reinterpret_cast<int4*>(smp + i0) = make_int4(s[0], s[1], s[2],
                                                       s[3]);
      }
      *reinterpret_cast<uint32_t*>(valid + i0) = pack4(v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < F) {
          rid[i0 + k] = a[k];
          off[i0 + k] = o[k];
          if (kCol != kNone) smp[i0 + k] = s[k];
          valid[i0 + k] = v[k];
        }
      }
    }
  }
}

// K15: a warp a query; ``bins`` the warp's S counters, in shared memory
// or the query's row of ``hist``.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    capped_hist_kernel(const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ valid, int B, int H,
                       const int32_t* __restrict__ r2s, int num_reads, int S,
                       int wpb, int32_t* __restrict__ hist) {
  extern __shared__ int32_t cells[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= wpb) return;  // the warp has no bins (a whole warp leaves)
  const int per_grid = static_cast<int>(gridDim.x) * wpb;
  for (int b = static_cast<int>(blockIdx.x) * wpb + warp; b < B;
       b += per_grid) {
    int32_t* row = hist + static_cast<long long>(b) * S;
    int32_t* bins = kShared ? cells + warp * S : row;
    for (int s = lane; s < S; s += 32) bins[s] = 0;
    __syncwarp();
    const int32_t* bid = ids + static_cast<long long>(b) * H;
    const uint8_t* bv = valid + static_cast<long long>(b) * H;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int h = h0 + lane;
      int s = -1;
      if (h < H && bv[h]) {
        const int r = bid[h];
        s = r2s == nullptr
                ? r
                : r2s[r < 0 ? 0 : (r >= num_reads ? num_reads - 1 : r)];
        if (static_cast<unsigned>(s) >= static_cast<unsigned>(S)) s = -1;
      }
      if (__ballot_sync(kFull, s >= 0)) {
        const unsigned peers = __match_any_sync(kFull, s);
        if (s >= 0 && __ffs(peers) - 1 == lane) {
          atomicAdd(&bins[s], __popc(peers));
        }
      }
    }
    __syncwarp();
    if (kShared) {
      for (int s = lane; s < S; s += 32) row[s] = bins[s];
      __syncwarp();
    }
  }
}

bool valid_lanes(long long B, int H, long long R_c) {
  return B >= 0 && H >= 1 && R_c >= 0 && B * H < (1LL << 31) &&
         R_c < (1LL << 31);
}

template <typename T>
int launch_compact(const void* l, const void* u, int B, int H, int R_c,
                   void* prefix, void* rows, void* valid, cudaStream_t st) {
  long long per = kSlotsPerBlock;
  const long long cap = static_cast<long long>(kMaxCompactBlocks) * per;
  if (R_c > cap) {  // fewer, longer stretches: each block scans the batch
    per = (R_c + kMaxCompactBlocks - 1) / kMaxCompactBlocks;
    per = (per + kSlotsPerBlock - 1) / kSlotsPerBlock * kSlotsPerBlock;
  }
  const unsigned grid = R_c ? static_cast<unsigned>((R_c + per - 1) / per)
                            : 1u;
  const int smem = kChunk * sizeof(T) + (kChunk + 1) * sizeof(int32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      row_compact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_compact_kernel<T><<<grid, kScanThreads, smem, st>>>(
      static_cast<const T*>(l), static_cast<const T*>(u), B, H, R_c,
      static_cast<int>(per), static_cast<int32_t*>(prefix),
      static_cast<T*>(rows), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

template <int kCol>
void launch_gather(const void* prefix, int B, int H, int R_c,
                   const void* rid_c, const void* off_c, const void* col,
                   int num_reads, void* rid, void* off, void* smp,
                   void* valid, cudaStream_t st) {
  const long long groups = (static_cast<long long>(B) * H + 3) / 4;
  row_gather_kernel<kCol><<<grid_for(groups, kThreads), kThreads, 0, st>>>(
      static_cast<const int32_t*>(prefix), B, H, R_c,
      static_cast<const int32_t*>(rid_c), static_cast<const int32_t*>(off_c),
      static_cast<const int32_t*>(col), num_reads, static_cast<int32_t*>(rid),
      static_cast<int32_t*>(off), static_cast<int32_t*>(smp),
      static_cast<uint8_t*>(valid));
}

}  // namespace

// K14, before the walk: the exclusive prefix of each query's lanes
// (prefix, int32 [B + 1]) and the budget's R_c slots (rows int32, or int64
// where row64, as l and u are, both 16-byte aligned; valid uint8), in one
// launch.
extern "C" int rs_row_compact(const void* l, const void* u, int row64,
                              long long B, int H, long long R_c, void* prefix,
                              void* rows, void* valid, void* stream) {
  if (!valid_lanes(B, H, R_c) || reinterpret_cast<uintptr_t>(l) % 16 ||
      reinterpret_cast<uintptr_t>(u) % 16) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), r = static_cast<int>(R_c);
  return row64 ? launch_compact<int64_t>(l, u, b, H, r, prefix, rows, valid,
                                         st)
               : launch_compact<int32_t>(l, u, b, H, r, prefix, rows, valid,
                                         st);
}

// K14, after the walk: the budget's answers (rid_c, off_c [R_c]) back to
// the [B, H] lanes (rid, off int32, valid uint8) through the prefix of
// rs_row_compact.  ``column`` 1: smp int32 [B, H] the slot's sample (col =
// the walk's samples [R_c]), 0 where the lane drops; 2: smp the sample of
// read clip(rid, 0, num_reads - 1) (col = read_to_sample), -1 where the
// lane drops; 0: no third column.
extern "C" int rs_row_gather(const void* prefix, long long B, int H,
                             long long R_c, const void* rid_c,
                             const void* off_c, int column, const void* col,
                             long long num_reads, void* rid, void* off,
                             void* smp, void* valid, void* stream) {
  if (!valid_lanes(B, H, R_c) || column < kNone || column > kReadSample ||
      (column == kReadSample && (num_reads < 1 || num_reads >= (1LL << 31)))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), r = static_cast<int>(R_c);
  const int m = static_cast<int>(num_reads);
  if (column == kSlotSample) {
    launch_gather<kSlotSample>(prefix, b, H, r, rid_c, off_c, col, m, rid,
                               off, smp, valid, st);
  } else if (column == kReadSample) {
    launch_gather<kReadSample>(prefix, b, H, r, rid_c, off_c, col, m, rid,
                               off, smp, valid, st);
  } else {
    launch_gather<kNone>(prefix, b, H, r, rid_c, off_c, col, m, rid, off,
                         smp, valid, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K15: hist int32 [B, S] of the valid lanes (valid uint8 [B, H]) by sample:
// ids [B, H] are read ids, their samples read_to_sample[clip(id, 0,
// num_reads - 1)]; or, where read_to_sample is null, the samples.
extern "C" int rs_capped_histogram(const void* ids, const void* valid,
                                   long long B, int H,
                                   const void* read_to_sample,
                                   long long num_reads, int S, void* hist,
                                   void* stream) {
  if (B < 0 || H < 1 || S < 1 || B * H >= (1LL << 31) ||
      (read_to_sample != nullptr &&
       (num_reads < 1 || num_reads >= (1LL << 31)))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* r2s = static_cast<const int32_t*>(read_to_sample);
  auto* h = static_cast<int32_t*>(hist);
  const int b = static_cast<int>(B), m = static_cast<int>(num_reads);
  if (S <= kHistSmemInts) {
    const int wpb = kHistSmemInts / S < kWarps ? kHistSmemInts / S : kWarps;
    capped_hist_kernel<true>
        <<<grid_for(B, wpb), kThreads, wpb * S * sizeof(int32_t), st>>>(
            i, v, b, H, r2s, m, S, wpb, h);
  } else {
    capped_hist_kernel<false><<<grid_for(B, kWarps), kThreads, 0, st>>>(
        i, v, b, H, r2s, m, S, kWarps, h);
  }
  return static_cast<int>(cudaGetLastError());
}
