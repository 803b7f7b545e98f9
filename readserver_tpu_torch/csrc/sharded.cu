// K9-K11: the interval-sharded index, every shard resident on one card.
//
// Replaces the device code of readserver_tpu/parallel/sharded.py, where
// each shard is a device of the 'shard' mesh axis and one psum merges
// the shards' masked contributions:
//   K9  rs_shard_occ         _ShardLocal.occ_global, occ_plane_global and
//                            occ_global_routed (395-487): the global rank
//                            over the base, pair, triple or mark tables;
//       rs_sharded_search    _query_body's search half (622-830): the
//                            masked 1-step scan or the pair/triple
//                            schedule, from C or the prefix LUT;
//   K11 rs_sharded_lut_level build_prefix_lut_sharded.level_body
//                            (1075-1089);
//   K10 rs_sharded_resolve   the lookups (489-619: sym, dollar, sample,
//                            dsa, lf, mark rank, sample pairs), do_walk's
//                            three routes (834-900: dsa, the lf walk with
//                            its terminal, the slow walk) and the exact
//                            sweep (947-988).
//
// The owner form.  Of the S terms each masked psum adds, at most one is
// nonzero: a position lies in one shard's range.  Rank is the exception,
// where the shards below the position add their totals.  So a lane finds
// the shard that owns its key by a binary search over the shards' starts
// (staged in shared memory, S <= 64) and reads one row there:
//   rank(c, i) = prefix[s][c] + occ_s(c, i - start_s), with the exclusive
//   prefix over shards of the shards' totals;
//   a lookup is the owning shard's chunk at the key, or 0 when no shard
//   owns it (an empty shard owns nothing; a rank at i >= n is the last
//   nonempty shard's count at its end).
// The same integer as the clamped sum, with one row read where the JAX
// program reads S.  occ_s is K1's row code (rank.cuh), and the tables are
// stacked [S, rows, row_words] with a shard stride of the padded rows.
//
// What bounds them on the H100: as their single-device counterparts (K1,
// K2, K5-K7), chains of dependent random row reads (the search, the walks)
// and, at full width, the rate of those reads.  The owner search adds
// log2(S) shared-memory reads to each rank and lookup.  One thread per
// lane, grid-stride; the sweep's limit, min(total, cap), is read on the
// card, so no launch waits for the host.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 128;

// The owner view; ops/sharded.py's ShardView mirrors it field for field
// (every field 8 bytes, a missing table null).  Strides are in elements of
// the table's type (uint32 words, int32 entries, int32 pairs).
struct ShardView {
  long long S, n, num_reads, log2_block, words_per_block, row_words,
      rows_per_symbol, sample_rate, max_read_len, dsa_bits;
  const long long* starts;  // [S] position ranges
  const long long* lens;
  const long long* C;   // [6]
  const long long* C2;  // [16]
  const long long* C3;  // [64]
  const uint32_t* rank;
  long long rank_stride;
  const long long* rank_prefix;  // [S + 1, 5]
  const uint32_t* rank2;
  long long rank2_stride;
  const long long* rank2_prefix;  // [S + 1, 16]
  const uint32_t* rank3;
  long long rank3_stride;
  const long long* rank3_prefix;  // [S + 1, 64]
  const uint32_t* sym4;
  long long sym4_stride;
  const int32_t* dollar;  // $-rank ranges
  long long dollar_stride;
  const long long* dstarts;
  const long long* dlens;
  const int32_t* sample;  // read-id ranges
  long long sample_stride;
  const long long* rstarts;
  const long long* rlens;
  const uint32_t* dsa;
  long long dsa_stride;
  const int32_t* lf;
  long long lf_stride;
  const uint32_t* marks;
  long long marks_stride;
  const long long* mark_prefix;  // [S + 1]
  const int32_t* spairs;         // mark-rank ranges, pairs (read id, offset)
  long long spairs_stride;
  const long long* sstarts;
  const long long* slens;
};

// One rank table of the view: its stacked rows, stride, prefix, planes.
struct Table {
  const uint32_t* rows;
  long long stride;
  const long long* prefix;
  int planes;
};

__device__ __forceinline__ Table table_of(const ShardView& v, int which) {
  switch (which) {
    case 1: return {v.rank2, v.rank2_stride, v.rank2_prefix, 16};
    case 2: return {v.rank3, v.rank3_stride, v.rank3_prefix, 64};
    case 3: return {v.marks, v.marks_stride, v.mark_prefix, 1};
    default: return {v.rank, v.rank_stride, v.rank_prefix, 5};
  }
}

// The owner keys a block searches, staged in shared memory.
struct Keys {
  long long pos[kMaxShards];   // starts
  long long dol[kMaxShards];   // dstarts
  long long rid[kMaxShards];   // rstarts
  long long slot[kMaxShards];  // sstarts
};

// Every thread of the block calls it; `all` stages the payload keys too.
__device__ __forceinline__ void stage_keys(const ShardView& v, Keys& k,
                                           bool all) {
  for (int s = threadIdx.x; s < v.S; s += blockDim.x) {
    k.pos[s] = v.starts[s];
    if (all) {
      k.dol[s] = v.dstarts[s];
      k.rid[s] = v.rstarts[s];
      k.slot[s] = v.sstarts != nullptr ? v.sstarts[s] : 0;
    }
  }
  __syncthreads();
}

// The last range starting at or before x: the number of keys <= x, less
// one (-1 when none).  Keys are nondecreasing.
__device__ __forceinline__ int owner(const long long* keys, int S,
                                     long long x) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// Global rank over table t: Σ_s occ_s(c, clamp(i - start_s, 0, len_s)),
// as prefix[s][c] + occ_s(c, i - start_s) at the owner s.  Nonempty shards
// come first (start_s = min(s * target, n)), so the owner of 0 <= i < n is
// nonempty; i >= n takes the last nonempty shard at its end.
__device__ __forceinline__ long long shard_rank(const ShardView& v,
                                                const long long* pos,
                                                const Table& t, int c,
                                                long long i) {
  if (i <= 0 || v.n <= 0) return 0;
  int s;
  long long loc;
  if (i < v.n) {
    s = owner(pos, static_cast<int>(v.S), i);
    loc = i - pos[s];
  } else {
    s = owner(pos, static_cast<int>(v.S), v.n - 1);
    loc = __ldg(v.lens + s);
  }
  const rs::Layout g{t.planes == 1 ? 1 : v.rows_per_symbol,
                     static_cast<int>(v.log2_block),
                     static_cast<int>(v.words_per_block),
                     static_cast<int>(v.row_words)};
  return __ldg(t.prefix + static_cast<long long>(s) * t.planes + c) +
         rs::occ_row(t.rows + s * t.stride, t.planes == 1 ? 0 : c,
                     static_cast<int32_t>(loc), g);
}

// The owning shard of key x among ranges (keys, lens) and x's index in its
// chunk, or -1 when no shard owns x.
__device__ __forceinline__ int owned(const long long* keys,
                                     const long long* lens, int S,
                                     long long x, long long& loc) {
  const int s = owner(keys, S, x);
  if (s < 0) return -1;
  loc = x - keys[s];
  return loc < __ldg(lens + s) ? s : -1;
}

__device__ __forceinline__ int sym_at(const ShardView& v, const Keys& k,
                                      long long i) {
  long long loc;
  const int s = owned(k.pos, v.lens, static_cast<int>(v.S), i, loc);
  if (s < 0) return 0;
  const uint32_t w = __ldg(v.sym4 + s * v.sym4_stride + (loc >> 3));
  return static_cast<int>((w >> ((loc & 7) * 4)) & 0xFu);
}

__device__ __forceinline__ int32_t lf_at(const ShardView& v, const Keys& k,
                                         long long i) {
  long long loc;
  const int s = owned(k.pos, v.lens, static_cast<int>(v.S), i, loc);
  return s < 0 ? 0 : __ldg(v.lf + s * v.lf_stride + loc);
}

__device__ __forceinline__ int32_t dollar_at(const ShardView& v,
                                             const Keys& k, long long dr) {
  long long loc;
  const int s = owned(k.dol, v.dlens, static_cast<int>(v.S), dr, loc);
  return s < 0 ? 0 : __ldg(v.dollar + s * v.dollar_stride + loc);
}

__device__ __forceinline__ int32_t sample_at(const ShardView& v,
                                             const Keys& k, long long r) {
  long long loc;
  const int s = owned(k.rid, v.rlens, static_cast<int>(v.S), r, loc);
  return s < 0 ? 0 : __ldg(v.sample + s * v.sample_stride + loc);
}

__device__ __forceinline__ int2 pair_at(const ShardView& v, const Keys& k,
                                        long long slot) {
  long long loc;
  const int s = owned(k.slot, v.slens, static_cast<int>(v.S), slot, loc);
  if (s < 0) return make_int2(0, 0);
  const int32_t* p = v.spairs + (s * v.spairs_stride + loc) * 2;
  return make_int2(__ldg(p), __ldg(p + 1));
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

// ------------------------------------------------------------------- K9

__global__ void __launch_bounds__(kThreads)
    shard_occ_kernel(ShardView v, int which, const int32_t* __restrict__ c,
                     const long long* __restrict__ i,
                     long long* __restrict__ out, long long X) {
  __shared__ Keys k;
  stage_keys(v, k, false);
  const Table t = table_of(v, which);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < X; x += stride) {
    out[x] = shard_rank(v, k.pos, t, c[x], i[x]);
  }
}

// ------------------------------------------------------------------ K11

__global__ void __launch_bounds__(kThreads)
    sharded_lut_level_kernel(ShardView v, const long long* __restrict__ l_in,
                             const long long* __restrict__ u_in, long long X,
                             long long* __restrict__ out_l,
                             long long* __restrict__ out_u, long long stride) {
  __shared__ Keys k;
  stage_keys(v, k, false);
  const Table t = table_of(v, 0);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < X; x += step) {
    const long long l = l_in[x];
    const long long u = u_in[x];
    const bool alive = l < u;
#pragma unroll
    for (int c = 1; c <= 4; ++c) {
      long long nl = l, nu = u;
      if (alive) {
        const long long base = __ldg(v.C + c);
        nl = base + shard_rank(v, k.pos, t, c, l);
        nu = base + shard_rank(v, k.pos, t, c, u);
      }
      out_l[(c - 1) * stride + x] = nl;
      out_u[(c - 1) * stride + x] = nu;
    }
  }
}

// ------------------------------------------------------- the search

__device__ __forceinline__ void search_step(const ShardView& v,
                                            const long long* pos,
                                            const Table& t,
                                            const long long* starts, int code,
                                            long long& l, long long& u) {
  const long long base = __ldg(starts + code);
  const long long ol = shard_rank(v, pos, t, code, l);
  const long long ou = shard_rank(v, pos, t, code, u);
  l = base + ol;
  u = base + ou;
}

// codes: int32 [B, K], right-aligned codes 1..4, 0 padding on the left.
// kstep 1: the masked scan over columns < r (r = K - p with the LUT, else
// K - 1), column j active while j >= K - lengths[b].  kstep 2, 3: every
// query of length K; triples (kstep 3), then pairs, then one single step.
// A query whose searched columns hold a code outside 1..4, or whose length
// lies outside [1, K], reads no table, gives (0, 0) and adds one to *bad.
__global__ void __launch_bounds__(kThreads)
    sharded_search_kernel(ShardView v, const int32_t* __restrict__ codes,
                          const int32_t* __restrict__ lengths, long long B,
                          int K, const long long* __restrict__ lut, int p,
                          int kstep, long long* __restrict__ out_l,
                          long long* __restrict__ out_u,
                          int32_t* __restrict__ bad) {
  __shared__ Keys k;
  stage_keys(v, k, false);
  const Table t1 = table_of(v, 0), t2 = table_of(v, 1), t3 = table_of(v, 2);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       b < B; b += stride) {
    const int32_t* q = codes + b * K;
    int len = K;
    int from = 0;  // first column the search reads
    bool ok = true;
    if (kstep <= 1) {
      len = lengths[b];
      ok = len >= 1 && len <= K;
      from = K - len;
      if (lut != nullptr && K - p < from) from = K - p;
    }
    for (int j = ok ? from : K; j < K; ++j) {
      ok = ok && q[j] >= 1 && q[j] <= 4;
    }
    if (!ok) {
      atomicAdd(bad, 1);
      out_l[b] = 0;
      out_u[b] = 0;
      continue;
    }
    long long l, u;
    int r;
    if (lut != nullptr) {
      long long id = 0;  // first character most significant
      for (int j = K - p; j < K; ++j) id = id * 4 + (q[j] - 1);
      l = __ldg(lut + 2 * id);
      u = __ldg(lut + 2 * id + 1);
      r = K - p;
    } else {
      const int c = q[K - 1];  // occ(c, 0) = 0, occ(c, n) = count(c)
      l = __ldg(v.C + c);
      u = __ldg(v.C + c + 1);
      r = K - 1;
    }
    if (kstep >= 2) {
      const int ntriples = kstep >= 3 ? r / 3 : 0;
      const int rem = r - 3 * ntriples;
      for (int j = r - 3; j >= rem && l < u; j -= 3) {
        const int code = (q[j] - 1) * 16 + (q[j + 1] - 1) * 4 + (q[j + 2] - 1);
        search_step(v, k.pos, t3, v.C3, code, l, u);
      }
      for (int j = rem - 2; j >= (rem & 1) && l < u; j -= 2) {
        const int code = (q[j] - 1) * 4 + (q[j + 1] - 1);
        search_step(v, k.pos, t2, v.C2, code, l, u);
      }
      if ((rem & 1) && l < u) search_step(v, k.pos, t1, v.C, q[0], l, u);
    } else {
      for (int j = r - 1; j >= K - len && l < u; --j) {
        search_step(v, k.pos, t1, v.C, q[j], l, u);
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

// ------------------------------------------------------------------ K10

enum WalkKind { kDsa = 0, kLf = 3, kSlow = 4 };

// One lane's resolve of SA row `row`: (read id, offset), -1 each where the
// lane is invalid or its walk did not end (the JAX do_walk's routes).
template <int KIND>
__device__ __forceinline__ void walk(const ShardView& v, const Keys& k,
                                     long long row, bool valid, int32_t& rid,
                                     int32_t& off) {
  rid = -1;
  off = -1;
  if (!valid) return;
  if constexpr (KIND == kDsa) {
    long long loc;
    const int s = owned(k.pos, v.lens, static_cast<int>(v.S), row, loc);
    const uint32_t p = s < 0 ? 0u : __ldg(v.dsa + s * v.dsa_stride + loc);
    const int bits = static_cast<int>(v.dsa_bits);
    rid = static_cast<int32_t>(p >> bits);
    off = static_cast<int32_t>(p & ((1u << bits) - 1u));
  } else if constexpr (KIND == kLf) {
    // a walk ends at a sampled row (sign bit) or a $ row (LF value below
    // m, its $-rank); it must end within max(sample_rate, 1) reads
    const Table marks = table_of(v, 3);
    long long cur = row;
    int steps = 0;
    bool done = false;
    const long long limit = v.sample_rate > 1 ? v.sample_rate : 1;
    int32_t raw = 0;
    for (long long t = 0; t < limit; ++t) {
      raw = lf_at(v, k, cur);
      const long long val = raw & 0x7FFFFFFF;
      if (raw < 0 || val < v.num_reads) {
        done = true;
        break;
      }
      cur = val;
      ++steps;
    }
    if (!done) return;
    if (raw < 0) {
      const int2 pr = pair_at(v, k, shard_rank(v, k.pos, marks, 0, cur));
      rid = pr.x;
      off = pr.y + steps;
    } else {
      rid = dollar_at(v, k, raw & 0x7FFFFFFF);
      off = steps;
    }
  } else {
    // the slow walk: one symbol and its rank a step, up to the longest
    // read; at a $ the rank occ($, cur) is the $-rank, looked up once
    const Table base = table_of(v, 0);
    long long cur = row;
    for (long long t = 0; t < v.max_read_len; ++t) {
      const int c = sym_at(v, k, cur);
      const long long o = shard_rank(v, k.pos, base, c, cur);
      if (c == 0) {
        rid = dollar_at(v, k, o);
        off = static_cast<int32_t>(t);
        return;
      }
      cur = __ldg(v.C + c) + o;
    }
  }
}

__device__ __forceinline__ long long clip_read(const ShardView& v,
                                               int32_t rid) {
  const long long hi = v.num_reads > 0 ? v.num_reads - 1 : 0;
  return rid < 0 ? 0 : (rid > hi ? hi : rid);
}

// Rows [R] where valid → read id, offset and the sample of
// clip(read id, 0, m - 1).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    sharded_resolve_kernel(ShardView v, const long long* __restrict__ rows,
                           const uint8_t* __restrict__ valid, long long R,
                           int32_t* __restrict__ rid_out,
                           int32_t* __restrict__ off_out,
                           int32_t* __restrict__ smp_out) {
  __shared__ Keys k;
  stage_keys(v, k, true);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < R; x += stride) {
    int32_t rid, off;
    walk<KIND>(v, k, rows[x], valid[x] != 0, rid, off);
    rid_out[x] = rid;
    off_out[x] = off;
    smp_out[x] = sample_at(v, k, clip_read(v, rid));
  }
}

// The exact sweep: slots g < min(total, cap) of the concatenated intervals
// (cum: int64 inclusive prefix sums of the counts) → query q, the number
// of sums at most g, and SA row l[q] + g - cum[q - 1]; walked to its read,
// whose sample's cell of q gains one.  An unterminated walk (-1) clips to
// read 0, as the JAX sweep does.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    sharded_sweep_kernel(ShardView v, const long long* __restrict__ l,
                         const long long* __restrict__ cum, long long B,
                         long long cap, int NS, int32_t* __restrict__ hist) {
  __shared__ Keys k;
  stage_keys(v, k, true);
  const long long total = cum[B - 1];
  const long long limit = cap < 0 ? total : (total < cap ? total : cap);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < limit; g += stride) {
    long long lo = 0, hi = B;  // sums at most g
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) <= g) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long q = lo < B - 1 ? lo : B - 1;
    const long long prev = q > 0 ? __ldg(cum + q - 1) : 0;
    int32_t rid, off;
    walk<KIND>(v, k, __ldg(l + q) + (g - prev), true, rid, off);
    const long long seg = q * NS + sample_at(v, k, clip_read(v, rid));
    if (seg >= 0 && seg < B * NS) atomicAdd(hist + seg, 1);
  }
}

// The sweep's grid: enough resident blocks to fill the card, since its
// limit is known only on the card.
template <typename F>
unsigned resident_grid(F kernel, long long max_slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long need = (max_slots + kThreads - 1) / kThreads;
  if (max_slots >= 0 && blocks > need) blocks = need;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <int KIND>
void launch_resolve(const ShardView& v, const void* rows, const void* valid,
                    long long R, void* rid, void* off, void* smp,
                    const void* l, const void* cum, long long B, long long cap,
                    int NS, void* hist, cudaStream_t st) {
  if (hist != nullptr) {
    sharded_sweep_kernel<KIND><<<resident_grid(sharded_sweep_kernel<KIND>,
                                               cap),
                                 kThreads, 0, st>>>(
        v, static_cast<const long long*>(l),
        static_cast<const long long*>(cum), B, cap, NS,
        static_cast<int32_t*>(hist));
  } else {
    sharded_resolve_kernel<KIND><<<grid_for(R, kThreads), kThreads, 0, st>>>(
        v, static_cast<const long long*>(rows),
        static_cast<const uint8_t*>(valid), R, static_cast<int32_t*>(rid),
        static_cast<int32_t*>(off), static_cast<int32_t*>(smp));
  }
}

bool view_ok(const ShardView& v) {
  return v.S >= 1 && v.S <= kMaxShards && v.starts != nullptr &&
         v.rank != nullptr && v.rank_prefix != nullptr && v.C != nullptr &&
         v.words_per_block >= 1 && v.row_words >= v.words_per_block + 1 &&
         (v.words_per_block << 5) == (1LL << v.log2_block);
}

}  // namespace

// K9: out[x] = the global rank over table `which` (0 base, 1 pair, 2
// triple, 3 marks) of plane c[x] (int32) before position i[x] (int64).
extern "C" int rs_shard_occ(const void* view, int which, const void* c,
                            const void* i, void* out, long long X,
                            void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const bool has = which == 0 || (which == 1 && v.rank2 != nullptr) ||
                   (which == 2 && v.rank3 != nullptr) ||
                   (which == 3 && v.marks != nullptr);
  if (!view_ok(v) || !has) return cudaErrorInvalidValue;
  shard_occ_kernel<<<grid_for(X, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      v, which, static_cast<const int32_t*>(c),
      static_cast<const long long*>(i), static_cast<long long*>(out), X);
  return static_cast<int>(cudaGetLastError());
}

// The search: (l, u) int64 [B] per query, empties (0, 0); see
// sharded_search_kernel.  K in [1, 256]; lut int64 [4^p, 2] or null.
extern "C" int rs_sharded_search(const void* view, const void* codes,
                                 const void* lengths, long long B, int K,
                                 const void* lut, int p, int kstep,
                                 void* out_l, void* out_u, void* bad,
                                 void* stream) {
  if (B <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  if (!view_ok(v) || K < 1 || K > 256 || (lut != nullptr && (p < 1 || p > K)) ||
      (kstep <= 1 && lengths == nullptr) ||
      (kstep >= 2 && (v.rank2 == nullptr || v.C2 == nullptr)) ||
      (kstep >= 3 && (v.rank3 == nullptr || v.C3 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  sharded_search_kernel<<<grid_for(B, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(lengths), B, K,
      static_cast<const long long*>(lut), lut != nullptr ? p : 0, kstep,
      static_cast<long long*>(out_l), static_cast<long long*>(out_u),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// K11: level l's X intervals → level l + 1's at (c - 1) * stride + x.
extern "C" int rs_sharded_lut_level(const void* view, const void* l,
                                    const void* u, long long X, void* out_l,
                                    void* out_u, long long stride,
                                    void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  if (!view_ok(v)) return cudaErrorInvalidValue;
  sharded_lut_level_kernel<<<grid_for(X, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const long long*>(l), static_cast<const long long*>(u),
      X, static_cast<long long*>(out_l), static_cast<long long*>(out_u),
      stride);
  return static_cast<int>(cudaGetLastError());
}

// K10, route `kind` (0 dsa, 3 lf, 4 slow).  hist null: rows int64 [R]
// where valid (uint8) → rid, off, smp int32 [R].  hist given: the exact
// sweep of l int64 [B] and cum int64 [B] up to min(total, cap) (cap -1: no
// cap) into hist int32 [B, NS].
extern "C" int rs_sharded_resolve(const void* view, int kind,
                                  const void* rows, const void* valid,
                                  long long R, void* rid, void* off,
                                  void* smp, const void* l, const void* cum,
                                  long long B, long long cap, int NS,
                                  void* hist, void* stream) {
  const ShardView& v = *static_cast<const ShardView*>(view);
  const bool sweep = hist != nullptr;
  if (sweep ? (B <= 0 || cap == 0) : R <= 0) return 0;
  const bool route_ok =
      (kind == kDsa && v.dsa != nullptr && v.dsa_bits >= 1 &&
       v.dsa_bits <= 31) ||
      (kind == kLf && v.lf != nullptr && v.marks != nullptr &&
       v.spairs != nullptr && v.sstarts != nullptr) ||
      (kind == kSlow && v.max_read_len >= 0);
  if (!view_ok(v) || !route_ok || v.dollar == nullptr ||
      v.sample == nullptr || (sweep && NS < 1)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kDsa:
      launch_resolve<kDsa>(v, rows, valid, R, rid, off, smp, l, cum, B, cap,
                           NS, hist, st);
      break;
    case kLf:
      launch_resolve<kLf>(v, rows, valid, R, rid, off, smp, l, cum, B, cap,
                          NS, hist, st);
      break;
    default:
      launch_resolve<kSlow>(v, rows, valid, R, rid, off, smp, l, cum, B, cap,
                            NS, hist, st);
  }
  return static_cast<int>(cudaGetLastError());
}
