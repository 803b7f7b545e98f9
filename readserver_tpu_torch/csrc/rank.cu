// K1: batched rank, occ(c[b], i[b]) for every b, and its prefix-LUT level
// entry.
//
// Replaces readserver_tpu/kernels/pallas_rank.py::_rank_kernel (the Pallas
// kernel, pallas_call at line 144), which the JAX package served as the XLA
// row gather of readserver_tpu/ops/rank.py::occ_rows.  The TPU kernel staged
// 128 rows per grid step through pipelined single-row DMAs.
//
// rs_rank_occ (the generic entry, counterpart of occ_pallas_rows): one
// independent random 16-byte row read per rank from a table larger than
// L2.  Two designs behind one entry, chosen by the batch and the table:
//
// * Direct (most batches): each thread carries four ranks, strided by the
//   block so every load of c, i and out is coalesced, and issues their
//   four row loads back to back.  Bound by the card's rate of random
//   sector reads from HBM (about 35 G a second on the H100,
//   scripts/torch_rank_ab.py's probe), and by latency when B is small.
//
// * Bucketed (B >= kBucketMinRanks ranks and at least one rank a row of a
//   table of 2..kMaxBuckets regions of kRegionBytes): the ranks then share
//   sectors (33,554,432 random ranks touch E. coli's 4,353,681 sectors
//   about 7.7 times each) that the direct design fetches again from HBM,
//   since the table does not fit in L2.  Three launches turn the reuse
//   into L2 hits:
//   1. partition: a block takes a tile of kTile ranks (c and i read once,
//      coalesced).  Where at least half of them read rows within
//      kLocalRows / 2 of the tile's middle rank (a sorted batch), the block
//      answers those itself, in order.  It sorts the rest by bucket (the
//      row's region of kRegionBytes) in shared memory (warp-aggregated
//      counts, a warp-shuffle scan) and writes them back in bucket order:
//      each rank's row within its region and bit offset packed in 32 bits,
//      its place in the tile in 16, and the tile's bucket offsets.  A
//      tile's runs stay in the tile's own stretch of the scratch, so no
//      block waits on another;
//   2. answer: blocks in bucket-major order, each over one bucket's runs
//      of kGroupTiles tiles, so the blocks resident at once read one or
//      two regions, which stay in L2 while every rank of the bucket reads
//      them (L2 keeps random lines all SMs read in about 24 MiB of its 50,
//      the probe: hence 8 MiB regions).  The answers overwrite the entries
//      in place.  Random reads from L2 run at about 134 G a second (the
//      probe), and this pass also moves the entries, answers and regions
//      through L2: it holds the design's time;
//   3. unpermute: a block takes each of its tiles' answers (contiguous) and
//      puts them back in the caller's order through shared memory, so out
//      is written coalesced (a tile the partition answered but for a few
//      strays: those alone, scattered).
//   Every pass streams: 4 + 4 B in, 4 + 2 B out (partition); 4 B in and
//   out and the table once from HBM (answer); 4 + 2 B in, 4 out
//   (unpermute).  At 33.5M ranks about 1.2 GB, against the direct
//   design's 33.5M random sector reads.
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

constexpr unsigned kFull = 0xFFFFFFFFu;

// The direct design.
constexpr int kThreads = 256;
constexpr int kPer = 4;  // ranks a thread, their row loads back to back

// The bucketed design.
constexpr int kTile = 1024;       // ranks a partition block
constexpr int kTileThreads = 256;
constexpr int kTilePer = kTile / kTileThreads;
constexpr int kUnpermuteTiles = 4;  // tiles an unpermute block puts back
constexpr int kAnswerThreads = 256;
constexpr int kAnswerPer = 4;     // entries a thread, loads back to back
// tiles an answer block walks: at most a warp's, and few enough that the
// blocks resident at once cover one or two buckets (64 read slower, PERF.md)
constexpr int kGroupTiles = 32;
constexpr int kMaxBuckets = 256;
constexpr long long kRegionBytes = 8LL << 20;  // a bucket's rows
constexpr long long kBucketMinRanks = 1LL << 22;
// the partition block answers the ranks of its tile that read rows within
// kLocalRows / 2 of its middle rank's, where they are half the tile or more
constexpr unsigned long long kLocalRows = 1ull << 16;
static_assert(kTile % kTileThreads == 0 && kTile <= 65536,
              "a tile's places are 16-bit");
static_assert(kGroupTiles <= 32, "one warp scans an answer block's runs");
static_assert(kMaxBuckets % 32 == 0, "one warp scans a tile's buckets");

// The bucketed design's shape for a batch, or tiles == 0: the direct one.
struct Plan {
  long long tiles = 0;
  int buckets = 0;
  int region_shift = 0;  // a region is 1 << region_shift rows
  size_t perm_at = 0, offs_at = 0, bytes = 0;  // scratch layout
};

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

Plan plan_for(long long B, long long table_rows, int log2_block,
              int row_words) {
  Plan p;
  if (B < kBucketMinRanks || B < table_rows || row_words < 1) return p;
  int shift = 0;
  while ((2LL << shift) * row_words * 4 <= kRegionBytes) ++shift;
  // an entry packs (row in region, bit offset) into 32 bits
  if (shift + log2_block > 32) return p;
  const long long buckets = (table_rows + (1LL << shift) - 1) >> shift;
  if (buckets < 2 || buckets > kMaxBuckets) return p;
  p.tiles = (B + kTile - 1) / kTile;
  p.buckets = static_cast<int>(buckets);
  p.region_shift = shift;
  const size_t slots = static_cast<size_t>(p.tiles) * kTile;
  p.perm_at = align256(slots * 4);
  p.offs_at = p.perm_at + align256(slots * 2);
  p.bytes = p.offs_at + align256(static_cast<size_t>(p.tiles) *
                                 (p.buckets + 1) * 4);
  return p;
}

// ---------------------------------------------------------------- direct

__global__ void __launch_bounds__(kThreads)
    rank_occ_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ c,
                    const int32_t* __restrict__ i, int32_t* __restrict__ out,
                    long long B, rs::Layout g) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kPer;
  for (long long b0 = static_cast<long long>(blockIdx.x) * kThreads * kPer +
                      threadIdx.x;
       b0 < B; b0 += step) {
    int32_t cc[kPer], ii[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long b = b0 + q * kThreads;
      cc[q] = b < B ? c[b] : 0;
      ii[q] = b < B ? i[b] : 0;
    }
    if (g.row_words == 4) {
      uint4 v[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        v[q] = b0 + q * kThreads < B
                   ? __ldg(reinterpret_cast<const uint4*>(rs::row_ptr(
                         table, cc[q], ii[q] >> g.log2_block, g)))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const long long b = b0 + q * kThreads;
        if (b < B) {
          out[b] = rs::count_row4(
              v[q], ii[q] - ((ii[q] >> g.log2_block) << g.log2_block),
              g.words_per_block);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const long long b = b0 + q * kThreads;
        if (b < B) out[b] = rs::occ_row(table, cc[q], ii[q], g);
      }
    }
  }
}

// -------------------------------------------------------------- bucketed

// Exclusive scan of counts[0..n) into starts[0..n], starts[n] the total,
// n <= kMaxBuckets, by warp 0 (each lane eight consecutive entries).
__device__ __forceinline__ void scan_buckets(const int* counts, int* starts,
                                             int n) {
  constexpr int kEach = kMaxBuckets / 32;
  const int lane = threadIdx.x;
  int v[kEach], sum = 0;
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const int r = lane * kEach + k;
    v[k] = r < n ? counts[r] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - sum;
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const int r = lane * kEach + k;
    if (r < n) starts[r] = run;
    run += v[k];
  }
  if (lane == 31) starts[n] = incl;
}

// The row of rank (c, i): 64-bit, as rs::row_ptr computes it.
__device__ __forceinline__ unsigned long long row_of(int32_t c, int32_t i,
                                                     const rs::Layout& g) {
  return static_cast<unsigned long long>(c) *
             static_cast<unsigned long long>(g.rows_per_symbol) +
         static_cast<unsigned long long>(i >> g.log2_block);
}

__global__ void __launch_bounds__(kTileThreads)
    rank_occ_partition_kernel(const uint32_t* __restrict__ table,
                              const int32_t* __restrict__ c,
                              const int32_t* __restrict__ i,
                              int32_t* __restrict__ out, long long B,
                              rs::Layout g, int region_shift, int buckets,
                              uint32_t* __restrict__ entries,
                              uint16_t* __restrict__ perm,
                              int32_t* __restrict__ offs) {
  __shared__ int counts[kMaxBuckets];
  __shared__ int starts[kMaxBuckets + 1];
  __shared__ uint32_t s_entry[kTile];
  __shared__ uint16_t s_perm[kTile];
  __shared__ unsigned long long s_anchor;
  __shared__ int s_near;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int n = static_cast<int>(B - base < kTile ? B - base : kTile);
  int32_t* my_offs = offs + blockIdx.x * static_cast<long long>(buckets + 1);
  for (int r = threadIdx.x; r < buckets; r += kTileThreads) counts[r] = 0;
  if (threadIdx.x == 0) s_near = 0;
  int32_t cc[kTilePer], ii[kTilePer];
#pragma unroll
  for (int k = 0; k < kTilePer; ++k) {
    const int j = k * kTileThreads + threadIdx.x;
    cc[k] = j < n ? __ldcs(c + base + j) : 0;
    ii[k] = j < n ? __ldcs(i + base + j) : 0;
    // the tile's anchor: the row of its middle rank
    if (j == n / 2) s_anchor = row_of(cc[k], ii[k], g);
  }
  __syncthreads();
  // the ranks within kLocalRows / 2 rows of the anchor are near
  const unsigned long long from = s_anchor - kLocalRows / 2;
  const int lane = threadIdx.x & 31;
  bool near[kTilePer];
#pragma unroll
  for (int k = 0; k < kTilePer; ++k) {
    near[k] = k * kTileThreads + threadIdx.x < n &&
              row_of(cc[k], ii[k], g) - from < kLocalRows;
    const unsigned votes = __ballot_sync(kFull, near[k]);
    if (lane == 0) atomicAdd(&s_near, __popc(votes));
  }
  __syncthreads();
  // a tile most of whose ranks are near (a sorted batch, with the odd
  // stray) answers those here, in order; the rest go to the buckets
  const bool direct = 2 * s_near >= n;
  if (direct) {
#pragma unroll
    for (int k = 0; k < kTilePer; ++k) {
      if (near[k]) {
        out[base + k * kTileThreads + threadIdx.x] =
            rs::occ_row(table, cc[k], ii[k], g);
      }
    }
    if (s_near == n) {  // nothing left for the other passes
      for (int r = threadIdx.x; r <= buckets; r += kTileThreads) {
        my_offs[r] = 0;
      }
      return;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  const unsigned long long in_region = (1ull << region_shift) - 1;
  // each bucketed rank's bucket (-1: none) and place among the block's
  // ranks of that bucket, packed (bucket + 1) << 16 | place; its entry
  uint32_t where[kTilePer], entry[kTilePer];
#pragma unroll
  for (int k = 0; k < kTilePer; ++k) {
    const int j = k * kTileThreads + threadIdx.x;
    const unsigned long long row = row_of(cc[k], ii[k], g);
    // (a c past the table's planes reads past it, as the direct design
    // does, but stays in the last bucket's counts)
    const unsigned long long r = row >> region_shift;
    const int bucket = j >= n || (direct && near[k]) ? -1
                       : r < static_cast<unsigned long long>(buckets)
                           ? static_cast<int>(r) : buckets - 1;
    entry[k] = (static_cast<uint32_t>(row & in_region) << g.log2_block) |
               static_cast<uint32_t>(ii[k] & ((1 << g.log2_block) - 1));
    // the warp's ranks of one bucket take consecutive places: one shared
    // atomic a bucket a warp
    const unsigned peers = __match_any_sync(kFull, bucket);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (lane == leader && bucket >= 0) {
      first = atomicAdd(&counts[bucket], __popc(peers));
    }
    where[k] = (static_cast<uint32_t>(bucket + 1) << 16) |
               static_cast<uint32_t>(__shfl_sync(kFull, first, leader) +
                                     __popc(peers & below));
  }
  __syncthreads();
  if (threadIdx.x < 32) scan_buckets(counts, starts, buckets);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTilePer; ++k) {
    const int bucket = static_cast<int>(where[k] >> 16) - 1;
    if (bucket >= 0) {
      const int slot = starts[bucket] + static_cast<int>(where[k] & 0xFFFF);
      s_entry[slot] = entry[k];
      s_perm[slot] = static_cast<uint16_t>(k * kTileThreads + threadIdx.x);
    }
  }
  for (int r = threadIdx.x; r <= buckets; r += kTileThreads) {
    my_offs[r] = starts[r];
  }
  __syncthreads();
  // the tile's runs: its bucketed ranks (all n, or the strays of a tile
  // answered here)
  for (int j = threadIdx.x; j < starts[buckets]; j += kTileThreads) {
    entries[base + j] = s_entry[j];
    perm[base + j] = s_perm[j];
  }
}

__global__ void __launch_bounds__(kAnswerThreads)
    rank_occ_answer_kernel(const uint32_t* __restrict__ table, rs::Layout g,
                           int region_shift, int buckets, long long tiles,
                           long long groups, const int32_t* __restrict__ offs,
                           uint32_t* __restrict__ entries) {
  __shared__ long long s_start[kGroupTiles];
  __shared__ int s_pre[kGroupTiles + 1];
  const int r = static_cast<int>(blockIdx.x / groups);
  const long long grp = blockIdx.x - r * groups;
  const long long t0 = grp * kGroupTiles;
  const int nt = static_cast<int>(tiles - t0 < kGroupTiles ? tiles - t0
                                                           : kGroupTiles);
  if (threadIdx.x < 32) {  // warp 0: the prefix of the tiles' runs
    const int lane = threadIdx.x;
    int len = 0;
    if (lane < nt) {
      const int32_t* o = offs + (t0 + lane) * (buckets + 1) + r;
      len = o[1] - o[0];
      s_start[lane] = (t0 + lane) * kTile + o[0];
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < nt) s_pre[lane + 1] = incl;
    if (lane == 0) s_pre[0] = 0;
  }
  __syncthreads();
  const int total = s_pre[nt];
  const uint32_t* region =
      table + (static_cast<size_t>(r) << region_shift) * g.row_words;
  const uint32_t within_mask = (1u << g.log2_block) - 1u;
  for (int k0 = 0; k0 < total; k0 += kAnswerThreads * kAnswerPer) {
    long long at[kAnswerPer];
    uint32_t e[kAnswerPer];
#pragma unroll
    for (int q = 0; q < kAnswerPer; ++q) {
      const int k = k0 + q * kAnswerThreads + threadIdx.x;
      at[q] = -1;
      e[q] = 0;
      if (k < total) {
        int lo = 0, hi = nt - 1;  // the tile whose run holds k
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_pre[mid] <= k) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        at[q] = s_start[lo] + (k - s_pre[lo]);
        e[q] = __ldcs(entries + at[q]);
      }
    }
    int32_t got[kAnswerPer];
    if (g.row_words == 4) {
      uint4 v[kAnswerPer];
#pragma unroll
      for (int q = 0; q < kAnswerPer; ++q) {
        v[q] = at[q] >= 0
                   ? __ldg(reinterpret_cast<const uint4*>(
                         region + static_cast<size_t>(e[q] >> g.log2_block) *
                                      4))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < kAnswerPer; ++q) {
        got[q] = rs::count_row4(v[q], static_cast<int>(e[q] & within_mask),
                                g.words_per_block);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kAnswerPer; ++q) {
        got[q] = at[q] < 0 ? 0
                           : rs::count_row(
                                 region + static_cast<size_t>(
                                              e[q] >> g.log2_block) *
                                              g.row_words,
                                 static_cast<int>(e[q] & within_mask),
                                 g.words_per_block);
      }
    }
#pragma unroll
    for (int q = 0; q < kAnswerPer; ++q) {
      if (at[q] >= 0) {
        __stcs(reinterpret_cast<int32_t*>(entries) + at[q], got[q]);
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
    rank_occ_unpermute_kernel(const int32_t* __restrict__ answers,
                              const uint16_t* __restrict__ perm,
                              const int32_t* __restrict__ offs, int buckets,
                              long long tiles, long long B,
                              int32_t* __restrict__ out) {
  __shared__ int32_t s_out[kTile];
  for (long long t = static_cast<long long>(blockIdx.x) * kUnpermuteTiles;
       t < tiles && t < (blockIdx.x + 1LL) * kUnpermuteTiles; ++t) {
    const long long base = t * kTile;
    const int n = static_cast<int>(B - base < kTile ? B - base : kTile);
    const int runs = offs[t * (buckets + 1) + buckets];
    if (runs < n) {
      // the partition answered the tile, all of it or all but these
      for (int j = threadIdx.x; j < runs; j += kTileThreads) {
        out[base + __ldcs(perm + base + j)] = __ldcs(answers + base + j);
      }
      continue;
    }
    __syncthreads();  // the last tile's s_out read
    for (int j = threadIdx.x; j < n; j += kTileThreads) {
      s_out[__ldcs(perm + base + j)] = __ldcs(answers + base + j);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kTileThreads) {
      out[base + j] = s_out[j];
    }
  }
}

// ------------------------------------------------------------ LUT level

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

unsigned grid_for(long long n, int per_block) {
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

}  // namespace

// The scratch rs_rank_occ needs for B ranks against a table of table_rows
// rows, in bytes at *bytes: 0 where the direct design runs.
extern "C" int rs_rank_occ_scratch(long long B, long long table_rows,
                                   int log2_block, int row_words,
                                   void* bytes) {
  if (bytes == nullptr) return cudaErrorInvalidValue;
  *static_cast<long long*>(bytes) = static_cast<long long>(
      plan_for(B, table_rows, log2_block, row_words).bytes);
  return 0;
}

// table: uint32 [table_rows, row_words]; c, i, out: int32 [B]; scratch:
// rs_rank_occ_scratch's bytes (none for the direct design), 16-byte
// aligned.
extern "C" int rs_rank_occ(const void* table, const void* c, const void* i,
                           void* out, long long B, long long rows_per_symbol,
                           int log2_block, int words_per_block, int row_words,
                           long long table_rows, void* scratch,
                           long long scratch_bytes, void* stream) {
  if (B <= 0) return 0;
  const rs::Layout g{rows_per_symbol, log2_block, words_per_block, row_words};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_for(B, table_rows, log2_block, row_words);
  if (p.tiles == 0) {
    rank_occ_kernel<<<grid_for(B, kThreads * kPer), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(table), static_cast<const int32_t*>(c),
        static_cast<const int32_t*>(i), static_cast<int32_t*>(out), B, g);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || scratch_bytes < static_cast<long long>(p.bytes) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      p.tiles > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  char* s = static_cast<char*>(scratch);
  uint32_t* entries = reinterpret_cast<uint32_t*>(s);
  uint16_t* perm = reinterpret_cast<uint16_t*>(s + p.perm_at);
  int32_t* offs = reinterpret_cast<int32_t*>(s + p.offs_at);
  rank_occ_partition_kernel<<<static_cast<unsigned>(p.tiles), kTileThreads,
                              0, st>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(i), static_cast<int32_t*>(out), B, g,
      p.region_shift, p.buckets, entries, perm, offs);
  const long long groups = (p.tiles + kGroupTiles - 1) / kGroupTiles;
  rank_occ_answer_kernel<<<static_cast<unsigned>(groups * p.buckets),
                           kAnswerThreads, 0, st>>>(
      static_cast<const uint32_t*>(table), g, p.region_shift,
      p.buckets, p.tiles, groups, offs, entries);
  rank_occ_unpermute_kernel<<<static_cast<unsigned>(
                                  (p.tiles + kUnpermuteTiles - 1) /
                                  kUnpermuteTiles),
                              kTileThreads, 0, st>>>(
      reinterpret_cast<const int32_t*>(entries), perm, offs, p.buckets,
      p.tiles, B, static_cast<int32_t*>(out));
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
