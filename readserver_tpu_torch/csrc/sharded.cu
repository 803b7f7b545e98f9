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
// the shard that owns its key from the shards' ranges, staged in shared
// memory (S <= 64): a position laid out evenly by the build by a multiply
// and a shift, any other key by a compare against every start for S <= 8,
// else a binary search.  It reads one row there:
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
// and, at full width, the rate of those reads.  So the search and K10's
// walks and sweep are the single-device designs with an owner accessor:
//   the search is search.cuh's body (K2's: TMA-staged codes packed to 2
//   bits in registers, blocks of 32 queries, a step's two row loads issued
//   together, each with its owner's prefix beside it in the same round);
//   K10's lf and slow walks and its exact sweep (every route) are
//   walk.cuh's persistent sweep (K6/K7's and rs_resolve_walk's: lane
//   refill over valid slots, the one-round slow step, terminal reads as
//   lane states, the sweep's tile mapping of slots to queries).
// A lane carries its global row, 32-bit for an index of fewer than 2^31
// rows (else 64-bit); each step locates it, (owner shard, local int32
// row), and forms the next global row from the owner's prefix (staged in
// shared memory) and the local count.  The walks are held by the
// instructions a step issues (PERF.md): a one-round owner search with more
// compares read slower than the search with a dependent read, and the
// 32-bit rows with the divisor faster than both.  K9 and K11 are one
// thread per lane, grid-stride (K9 with the prefix in shared memory);
// K10's dsa resolve a persistent grid of one lane a thread at a time.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"
#include "search.cuh"
#include "shard_view.cuh"
#include "walk.cuh"

namespace {

using rs::kDsa;
using rs::kLf;
using rs::kSlow;

constexpr int kMaxShards = 64;
constexpr int kSmallShards = 8;  // owner search by compares up to here
constexpr int kThreads = 128;    // K9, K11
constexpr int kWalkMinBlocks = 8;  // per SM, the walks and the sweep

using rs::ShardView;  // shard_view.cuh

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

// The layout of a table's shard: planes of rows_per_symbol rows (the mark
// table: one plane of its own rows).
__device__ __forceinline__ rs::Layout layout_of(const ShardView& v,
                                                int planes) {
  return rs::Layout{planes == 1 ? 1 : v.rows_per_symbol,
                    static_cast<int>(v.log2_block),
                    static_cast<int>(v.words_per_block),
                    static_cast<int>(v.row_words)};
}

// One kind of range (positions, $-ranks, read ids or mark ranks), staged in
// shared memory: the S shards' ranges [start, end), sorted and not
// overlapping (an empty range has start == end).
struct Ranges {
  long long start[kMaxShards], end[kMaxShards];
};

// The last range starting at or before x: the number of starts <= x, less
// one (-1 when none).  Up to kSmallShards ranges, one compare each; past
// that a binary search.
__device__ __forceinline__ int owner(const Ranges& r, int S, long long x) {
  if (S <= kSmallShards) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < kSmallShards; ++k) n += k < S && r.start[k] <= x;
    return n - 1;
  }
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (r.start[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// The range that owns x and x's index in it, or -1 when none does.
__device__ __forceinline__ int owned(const Ranges& r, int S, long long x,
                                     long long& loc) {
  const int s = owner(r, S, x);
  if (s < 0) return -1;
  loc = x - r.start[s];
  return x < r.end[s] ? s : -1;
}

// Positions laid out evenly over an index of fewer than 2^31 rows: shard s
// holds [min(s * size, n), min((s + 1) * size, n)), as the build lays them
// out, so the owner of 0 <= x < n is x / size, exactly umulhi(x, m) >> sh
// (division by an invariant integer: m = ceil(2^(31 + l) / size) with
// 2^(l - 1) < size <= 2^l, exact for x < 2^31): a few 32-bit instructions
// where a search of the staged ranges takes tens on every step of a walk.
// size 0: the positions are not even, or the index is larger; search the
// ranges.
struct Even {
  uint32_t size, m;
  int sh;

  __device__ __forceinline__ int owner(uint32_t x) const {
    return static_cast<int>(__umulhi(x, m) >> sh);
  }
};

// The divisor of shards of `size` positions, if the index has fewer than
// 2^31 (one thread a block computes it).
__device__ __forceinline__ Even even_for(long long size, long long n) {
  if (size < 2 || n >= (1LL << 31)) return Even{0, 0, 0};
  const int l = 32 - __clz(static_cast<unsigned>(size - 1));
  const unsigned long long m =
      ((1ull << (31 + l)) + static_cast<unsigned long long>(size) - 1) /
      static_cast<unsigned long long>(size);
  return Even{static_cast<uint32_t>(size), static_cast<uint32_t>(m), l - 1};
}

// Stage ranges (starts, lens) of S shards into r; every thread of the block
// calls it, and the caller's next __syncthreads orders the stores.  Null
// keys stage empty ranges.
__device__ __forceinline__ void stage_ranges(Ranges& r,
                                             const long long* starts,
                                             const long long* lens, int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long a = starts != nullptr ? starts[s] : 0;
    r.start[s] = a;
    r.end[s] = starts != nullptr ? a + lens[s] : a;
  }
}

// Stage the positions' ranges into r and, by thread 0, their divisor into
// e.  Returns whether the ranges this thread staged follow the even layout;
// the caller's next __syncthreads_and orders the stores and ANDs the flags
// (e holds only where every thread's flag held).
__device__ __forceinline__ bool stage_positions(Ranges& r, Even& e,
                                                const ShardView& v) {
  const int S = static_cast<int>(v.S);
  const long long size = __ldg(v.lens), n = v.n;
  stage_ranges(r, v.starts, v.lens, S);
  bool even = true;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long lo = s * size, hi = lo + size;
    even = even && __ldg(v.starts + s) == (lo < n ? lo : n) &&
           __ldg(v.lens + s) == (hi < n ? hi : n) - (lo < n ? lo : n);
  }
  if (threadIdx.x == 0) e = even_for(size, n);
  return even;
}

// The ranges and the rank prefixes a block reads, staged in shared memory.
struct Keys {
  Ranges pos, dol, rid, slot;  // positions, $-ranks, read ids, mark ranks
  Even even;                   // the positions' divisor
  long long prefix[(kMaxShards + 1) * 5];  // rank_prefix
  long long mprefix[kMaxShards + 1];       // mark_prefix
};

// What a kernel looks up: positions (K9, K11), positions and read ids (the
// dsa route), or every range and the rank prefixes (the lf and slow walks).
enum Lookups { kPositions, kDsaLookups, kWalkLookups };

// Every thread of the block calls it.  Returns stage_positions' flag; the
// caller's next __syncthreads_and orders the stores and ANDs the flags,
// and k.even holds the divisor after it.
__device__ __forceinline__ bool stage_keys(const ShardView& v, Keys& k,
                                           Lookups what) {
  const int S = static_cast<int>(v.S);
  const bool even = stage_positions(k.pos, k.even, v);
  if (what != kPositions) stage_ranges(k.rid, v.rstarts, v.rlens, S);
  if (what == kWalkLookups) {
    stage_ranges(k.dol, v.dstarts, v.dlens, S);
    stage_ranges(k.slot, v.sstarts, v.slens, S);
    for (int j = threadIdx.x; j < (S + 1) * 5; j += blockDim.x) {
      k.prefix[j] = v.rank_prefix[j];
    }
    for (int j = threadIdx.x; j <= S; j += blockDim.x) {
      k.mprefix[j] = v.mark_prefix != nullptr ? v.mark_prefix[j] : 0;
    }
  }
  return even;
}

// The owner of a position 0 <= x < n and its start: by division where the
// positions are even, else by the search.
__device__ __forceinline__ int pos_owner(const Ranges& r, const Even& e,
                                         int S, long long x,
                                         long long& start) {
  if (e.size > 0) {
    const int s = e.owner(static_cast<uint32_t>(x));
    start = static_cast<long long>(s) * e.size;
    return s;
  }
  const int s = owner(r, S, x);
  start = r.start[s];
  return s;
}

// Global rank over table t: Σ_s occ_s(c, clamp(i - start_s, 0, len_s)),
// as prefix[s][c] + occ_s(c, i - start_s) at the owner s.  Nonempty shards
// come first (start_s = min(s * target, n)), so the owner of 0 <= i < n is
// nonempty; i >= n takes the last nonempty shard at its end.
__device__ __forceinline__ long long shard_rank(const ShardView& v,
                                                const Keys& k, const Even& e,
                                                const Table& t, int c,
                                                long long i) {
  if (i <= 0 || v.n <= 0) return 0;
  const int S = static_cast<int>(v.S);
  long long start;
  const int s = pos_owner(k.pos, e, S, i < v.n ? i : v.n - 1, start);
  const long long loc = i < v.n ? i - start : k.pos.end[s] - start;
  return __ldg(t.prefix + static_cast<long long>(s) * t.planes + c) +
         rs::occ_row(t.rows + s * t.stride, t.planes == 1 ? 0 : c,
                     static_cast<int32_t>(loc), layout_of(v, t.planes));
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

// ------------------------------------------------------------------- K9

// One rank a thread (four a thread in blocks of 256 read slower on the
// H100: a rank's index load, owner and row are one chain, PERF.md), the
// table's prefix over shards staged in shared memory beside the
// positions' ranges, and the rank's c and i loaded before the block
// stages them.
__global__ void __launch_bounds__(kThreads)
    shard_occ_kernel(ShardView v, int which, const int32_t* __restrict__ c,
                     const long long* __restrict__ i,
                     long long* __restrict__ out, long long X) {
  extern __shared__ long long s_prefix[];  // [(S + 1) * planes]
  __shared__ Ranges pos;
  __shared__ Even even;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long x = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int32_t cc = x < X ? c[x] : 0;
  long long ii = x < X ? i[x] : 0;
  const Table t = table_of(v, which);
  const int S = static_cast<int>(v.S);
  const int staged = (S + 1) * t.planes;
  for (int j = threadIdx.x; j < staged; j += kThreads) {
    s_prefix[j] = t.prefix[j];
  }
  const Even e = __syncthreads_and(stage_positions(pos, even, v))
                     ? even : Even{0, 0, 0};
  const rs::Layout g = layout_of(v, t.planes);
  const long long n = v.n;
  for (; x < X; x += step) {
    // as shard_rank: the owner of min(i, n - 1), at its end for i >= n,
    // nothing read for i <= 0
    long long got = 0;
    const uint32_t* row = nullptr;
    int within = 0;
    if (ii > 0 && n > 0) {
      long long start;
      const int s = pos_owner(pos, e, S, ii < n ? ii : n - 1, start);
      const int32_t loc = static_cast<int32_t>(ii < n ? ii - start
                                                      : pos.end[s] - start);
      const long long j = static_cast<long long>(s) * t.planes + cc;
      got = j < staged ? s_prefix[j] : __ldg(t.prefix + j);
      const int32_t blk = loc >> g.log2_block;
      within = loc - (blk << g.log2_block);
      row = rs::row_ptr(t.rows + s * t.stride, t.planes == 1 ? 0 : cc, blk,
                        g);
    }
    if (row != nullptr) {
      got += g.row_words == 4
                 ? rs::count_row4(__ldg(reinterpret_cast<const uint4*>(row)),
                                  within, g.words_per_block)
                 : rs::count_row(row, within, g.words_per_block);
    }
    out[x] = got;
    if (x + step < X) {
      cc = c[x + step];
      ii = i[x + step];
    }
  }
}

// ------------------------------------------------------------------ K11

__global__ void __launch_bounds__(kThreads)
    sharded_lut_level_kernel(ShardView v, const long long* __restrict__ l_in,
                             const long long* __restrict__ u_in, long long X,
                             long long* __restrict__ out_l,
                             long long* __restrict__ out_u, long long stride) {
  __shared__ Keys k;
  const Even e = __syncthreads_and(stage_keys(v, k, kPositions))
                     ? k.even : Even{0, 0, 0};
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
        nl = base + shard_rank(v, k, e, t, c, l);
        nu = base + shard_rank(v, k, e, t, c, u);
      }
      out_l[(c - 1) * stride + x] = nl;
      out_u[(c - 1) * stride + x] = nu;
    }
  }
}

// ------------------------------------------------------- the search

// search.cuh's rank accessor over the shards: int64 intervals.  A rank
// at i <= 0 is 0; at i >= n the last nonempty shard's count at its end.
struct OwnerRank {
  using Pos = long long;
  const ShardView& v;
  const Ranges& pos;  // the shards' positions, in shared memory
  Even even;
  const long long* lut_rows;  // int64 [4^p, 2]
  int S;
  int last;            // the owner of n - 1
  int32_t last_len;    // its length
  rs::Layout g;

  __device__ __forceinline__ void lut(int32_t id, Pos& l, Pos& u) const {
    l = __ldg(lut_rows + 2 * static_cast<long long>(id));
    u = __ldg(lut_rows + 2 * static_cast<long long>(id) + 1);
  }

  __device__ __forceinline__ void start(int c, Pos& l, Pos& u) const {
    l = __ldg(v.C + c);
    u = __ldg(v.C + c + 1);
  }

  // (owner shard, local row) of a rank's position
  __device__ __forceinline__ void where(long long i, int& s,
                                        int32_t& loc) const {
    if (i < v.n) {
      const long long x = i > 0 ? i : 0;
      long long start;
      s = pos_owner(pos, even, S, x, start);
      loc = static_cast<int32_t>(x - start);
    } else {
      s = last;
      loc = last_len;
    }
  }

  template <int K>
  __device__ __forceinline__ void step(rs::Cols<K>, int code, Pos& l,
                                       Pos& u) const {
    constexpr int P = K == 3 ? 64 : (K == 2 ? 16 : 5);
    const uint32_t* rows = K == 3 ? v.rank3 : (K == 2 ? v.rank2 : v.rank);
    const long long stride =
        K == 3 ? v.rank3_stride : (K == 2 ? v.rank2_stride : v.rank_stride);
    const long long* prefix =
        K == 3 ? v.rank3_prefix : (K == 2 ? v.rank2_prefix : v.rank_prefix);
    const long long* starts = K == 3 ? v.C3 : (K == 2 ? v.C2 : v.C);
    int sl, su;
    int32_t ll, lu;
    where(l, sl, ll);
    where(u, su, lu);
    // one round: both rows, both prefixes and the plane's start
    const long long pl = __ldg(prefix + sl * P + code);
    const long long pu = __ldg(prefix + su * P + code);
    const long long base = __ldg(starts + code);
    int32_t ol, ou;
    rs::occ_pair(rows + sl * stride, rows + su * stride, code, ll, lu, g, ol,
                 ou);
    const bool any = v.n > 0;
    l = base + (l > 0 && any ? pl + ol : 0);
    u = base + (u > 0 && any ? pu + ou : 0);
  }
};

// kstep 1: the masked scan over columns < r (r = K - p with the LUT, else
// K - 1), column j active while j >= K - lengths[b].  kstep 2, 3: every
// query of length K; triples (kstep 3), then pairs, then one single step.
// See rs::search_block; dynamic shared memory rs::search_smem(K).
template <int NW>
__global__ void __launch_bounds__(rs::kSearchThreads)
    sharded_search_kernel(ShardView v, const int32_t* __restrict__ codes,
                          const int32_t* __restrict__ lengths, long long B,
                          int K, const long long* __restrict__ lut, int p,
                          int kstep, long long* __restrict__ out_l,
                          long long* __restrict__ out_u,
                          int32_t* __restrict__ bad) {
  extern __shared__ __align__(16) int32_t tile[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Ranges pos;
  __shared__ Even even;
  const int S = static_cast<int>(v.S);
  const Even e = __syncthreads_and(stage_positions(pos, even, v))
                     ? even : Even{0, 0, 0};
  long long start = 0;
  const int last = v.n > 0 ? pos_owner(pos, e, S, v.n - 1, start) : 0;
  const OwnerRank a{v, pos, e, lut, S, last,
                    static_cast<int32_t>(pos.end[last] - pos.start[last]),
                    layout_of(v, 5)};
  rs::search_block<NW>(a, codes, lengths, B, K, lut != nullptr ? p : 0,
                       kstep >= 2 ? kstep : 0, out_l, out_u, bad, tile,
                       &bar);
}

// ------------------------------------------------------------------ K10

// walk.cuh's table accessor over the shards: a row located is (owner
// shard, local row), -1 where no shard owns it; a lookup outside every
// range gives 0; the sample of clip(read id, 0, m - 1).  P: the rows'
// type, int32_t for an index of fewer than 2^31 rows (every position,
// rank and C value then fits, and a step's arithmetic stays 32-bit), else
// long long.
template <class P>
struct OwnerTables {
  using Pos = P;
  struct Loc {
    int s;
    int32_t loc;
  };
  static constexpr bool kSample = true;
  static constexpr bool kRankTiles = false;  // walk.cuh's walk_tiles
  const ShardView& v;
  const Keys& k;
  Even even;
  P n;
  int S;
  int dsa_bits;
  int max_steps;
  rs::Layout layout;  // the base table's; the mark table's rows are one plane

  // an input row as a P: rows outside [0, n) stay outside
  __device__ __forceinline__ P from_input(long long row) const {
    return static_cast<P>(row < 0 ? -1 : (row > n ? n : row));
  }
  __device__ __forceinline__ Loc at(P row) const {
    if (row < 0 || row >= n) return {-1, 0};
    if (even.size > 0) {
      const uint32_t x = static_cast<uint32_t>(row);
      const int s = even.owner(x);
      return {s, static_cast<int32_t>(x - static_cast<uint32_t>(s) * even.size)};
    }
    long long loc = 0;
    const int s = owned(k.pos, S, row, loc);
    return {s, static_cast<int32_t>(loc)};
  }
  __device__ __forceinline__ bool inside(P row) const {
    return row >= 0 && row < n;
  }
  // the slow walk's $-rank at a row no shard owns: occ($, row), the
  // clamped sum, 0 below the index and the $ total past it
  __device__ __forceinline__ long long outside_drank(P row) const {
    return row <= 0 ? 0 : k.prefix[S * 5];
  }
  __device__ __forceinline__ int32_t local(Loc a) const { return a.loc; }
  __device__ __forceinline__ const uint32_t* rank_row(Loc a, int c) const {
    return rs::row_ptr(v.rank + a.s * v.rank_stride, c,
                       a.loc >> layout.log2_block, layout);
  }
  __device__ __forceinline__ const uint32_t* mark_row(Loc a) const {
    return v.marks + a.s * v.marks_stride +
           static_cast<size_t>(a.loc >> layout.log2_block) *
               static_cast<size_t>(layout.row_words);
  }
  __device__ __forceinline__ int32_t lf_word(Loc a) const {
    return a.s < 0 ? 0 : __ldg(v.lf + a.s * v.lf_stride + a.loc);
  }
  __device__ __forceinline__ uint32_t sym4_word(Loc a) const {
    return a.s < 0 ? 0u
                   : __ldg(v.sym4 + a.s * v.sym4_stride + (a.loc >> 3));
  }
  __device__ __forceinline__ P rank_of(Loc a, int c, int32_t count) const {
    return static_cast<P>(k.prefix[a.s * 5 + c]) + count;
  }
  __device__ __forceinline__ long long mark_slot(Loc a, int32_t count) const {
    return k.mprefix[a.s] + count;
  }
  __device__ __forceinline__ int2 pair(long long slot) const {
    long long loc = 0;
    const int s = owned(k.slot, S, slot, loc);
    if (s < 0) return make_int2(0, 0);
    return __ldg(reinterpret_cast<const int2*>(v.spairs) +
                 s * v.spairs_stride + loc);
  }
  __device__ __forceinline__ int32_t dollar(long long drank) const {
    long long loc = 0;
    const int s = owned(k.dol, S, drank, loc);
    return s < 0 ? 0 : __ldg(v.dollar + s * v.dollar_stride + loc);
  }
  __device__ __forceinline__ int32_t sample(long long rid) const {
    const long long hi = v.num_reads > 0 ? v.num_reads - 1 : 0;
    const long long r = rid < 0 ? 0 : (rid > hi ? hi : rid);
    long long loc = 0;
    const int s = owned(k.rid, S, r, loc);
    return s < 0 ? 0 : __ldg(v.sample + s * v.sample_stride + loc);
  }
  __device__ __forceinline__ uint32_t dsa_word(P row) const {
    const Loc a = at(row);
    return a.s < 0 ? 0u : __ldg(v.dsa + a.s * v.dsa_stride + a.loc);
  }
  __device__ __forceinline__ P C_at(int c) const {
    return static_cast<P>(__ldg(v.C + c));
  }
  // LF values below m (the reads, one $ each) are $ rows' $-ranks
  __device__ __forceinline__ P dollar_limit() const {
    return static_cast<P>(v.num_reads);
  }
};

template <class P>
__device__ __forceinline__ OwnerTables<P> tables_of(const ShardView& v,
                                                    const Keys& k, bool even,
                                                    int walk) {
  return OwnerTables<P>{
      v, k, even ? k.even : Even{0, 0, 0}, static_cast<P>(v.n),
      static_cast<int>(v.S), static_cast<int>(v.dsa_bits),
      walk == kLf ? static_cast<int>(v.sample_rate > 1 ? v.sample_rate : 1)
                  : static_cast<int>(v.max_read_len),
      layout_of(v, 5)};
}

// Rows [R] where valid → read id, offset and the sample of
// clip(read id, 0, m - 1); -1 each where the lane is invalid or its walk
// did not end (the JAX do_walk's routes).  A persistent grid: dsa, one
// lane a thread at a time (one read and the sample's where valid); lf,
// slow: walk.cuh's sweep (L: 16-byte rank rows).
template <int WALK, int L, class P>
__global__ void __launch_bounds__(rs::kSweepThreads, kWalkMinBlocks)
    sharded_resolve_kernel(ShardView v, rs::Sweep<long long> s) {
  __shared__ Keys k;
  const bool even = __syncthreads_and(
      stage_keys(v, k, WALK == kDsa ? kDsaLookups : kWalkLookups));
  const OwnerTables<P> g = tables_of<P>(v, k, even, WALK);
  if constexpr (WALK == kDsa) {
    const int32_t smp0 = g.sample(-1);  // an invalid lane's: read 0's
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         x < s.R; x += stride) {
      int32_t rid = -1, off = -1, smp = smp0;
      if (s.valid[x] != 0) {
        const uint32_t p = g.dsa_word(g.from_input(s.rows[x]));
        rid = static_cast<int32_t>(p >> g.dsa_bits);
        off = static_cast<int32_t>(p & ((1u << g.dsa_bits) - 1u));
        smp = g.sample(rid);
      }
      s.rid_out[x] = rid;
      s.off_out[x] = off;
      s.smp_out[x] = smp;
    }
  } else {
    rs::sweep<WALK, false, L>(g, s);
  }
}

// The exact sweep: slots g < min(total, cap) of the concatenated intervals
// (cum: int64 inclusive prefix sums of the counts) → query q, the number
// of sums at most g, and SA row l[q] + g - cum[q - 1]; walked to its read,
// whose sample's cell of q gains one.  An unterminated walk (-1) clips to
// read 0, as the JAX sweep does.
template <int WALK, int L, class P>
__global__ void __launch_bounds__(rs::kSweepThreads, kWalkMinBlocks)
    sharded_sweep_kernel(ShardView v, rs::Sweep<long long> s) {
  __shared__ Keys k;
  const bool even = __syncthreads_and(
      stage_keys(v, k, WALK == kDsa ? kDsaLookups : kWalkLookups));
  rs::sweep<WALK, true, L>(tables_of<P>(v, k, even, WALK), s);
}

// As many blocks as the card holds at once, no more than `max_blocks`.
template <typename F>
unsigned persistent_grid(F kernel, long long max_blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                rs::kSweepThreads, 0);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <int WALK, int L, class P>
void launch_resolve(const ShardView& v, const rs::Sweep<long long>& s,
                    cudaStream_t st) {
  constexpr int T = rs::kSweepThreads;
  if (s.hist != nullptr) {
    const long long most = s.cap < 0 ? (1LL << 20) : (s.cap + T - 1) / T;
    sharded_sweep_kernel<WALK, L, P>
        <<<persistent_grid(sharded_sweep_kernel<WALK, L, P>, most), T, 0,
           st>>>(v, s);
  } else {
    sharded_resolve_kernel<WALK, L, P>
        <<<persistent_grid(sharded_resolve_kernel<WALK, L, P>,
                           (s.R + T - 1) / T),
           T, 0, st>>>(v, s);
  }
}

// 32-bit rows for an index of fewer than 2^31 of them.
template <int WALK, int L>
void launch_positions(const ShardView& v, const rs::Sweep<long long>& s,
                      cudaStream_t st) {
  if (v.n < (1LL << 31)) {
    launch_resolve<WALK, L, int32_t>(v, s, st);
  } else {
    launch_resolve<WALK, L, long long>(v, s, st);
  }
}

// The instantiation for the rank rows' width: L = 1 for 16-byte rows (the
// dsa route reads no rank row).
template <int WALK>
void launch_rows(const ShardView& v, const rs::Sweep<long long>& s,
                 cudaStream_t st) {
  if constexpr (WALK == kDsa) {
    launch_positions<WALK, 1>(v, s, st);
  } else if (v.row_words == 4) {
    launch_positions<WALK, 1>(v, s, st);
  } else {
    launch_positions<WALK, 0>(v, s, st);
  }
}

bool view_ok(const ShardView& v) {
  return v.S >= 1 && v.S <= kMaxShards && v.starts != nullptr &&
         v.lens != nullptr && v.rank != nullptr &&
         v.rank_prefix != nullptr && v.C != nullptr &&
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
  const int planes = which == 1 ? 16 : which == 2 ? 64 : which == 3 ? 1 : 5;
  const size_t smem = static_cast<size_t>(v.S + 1) * planes * 8;
  shard_occ_kernel<<<grid_for(X, kThreads), kThreads, smem,
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
  const long long blocks = (B + rs::kSearchThreads - 1) / rs::kSearchThreads;
  if (!view_ok(v) || K < 1 || K > rs::kSearchMaxK || blocks > 0x7FFFFFFF ||
      (lut != nullptr && (p < 1 || p > K)) ||
      (kstep <= 1 && lengths == nullptr) ||
      (kstep >= 2 && (v.rank2 == nullptr || v.C2 == nullptr)) ||
      (kstep >= 3 && (v.rank3 == nullptr || v.C3 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RS_LAUNCH(NW)                                                        \
  sharded_search_kernel<NW><<<static_cast<unsigned>(blocks),                 \
                              rs::kSearchThreads, rs::search_smem(K), st>>>( \
      v, static_cast<const int32_t*>(codes),                                 \
      static_cast<const int32_t*>(lengths), B, K,                            \
      static_cast<const long long*>(lut), p, kstep,                          \
      static_cast<long long*>(out_l), static_cast<long long*>(out_u),        \
      static_cast<int32_t*>(bad))
  if (K <= 32) {
    RS_LAUNCH(1);
  } else if (K <= 64) {
    RS_LAUNCH(2);
  } else if (K <= 128) {
    RS_LAUNCH(4);
  } else {
    RS_LAUNCH(8);
  }
#undef RS_LAUNCH
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
       v.mark_prefix != nullptr && v.spairs != nullptr &&
       v.sstarts != nullptr && v.slens != nullptr) ||
      (kind == kSlow && v.max_read_len >= 1);
  if (!view_ok(v) || !route_ok || v.dollar == nullptr ||
      v.sample == nullptr || v.dstarts == nullptr || v.dlens == nullptr ||
      v.rstarts == nullptr || v.rlens == nullptr || (sweep && NS < 1)) {
    return cudaErrorInvalidValue;
  }
  rs::Sweep<long long> s{};
  s.rows = static_cast<const long long*>(rows);
  s.valid = static_cast<const uint8_t*>(valid);
  s.R = R;
  s.rid_out = static_cast<int32_t*>(rid);
  s.off_out = static_cast<int32_t*>(off);
  s.smp_out = static_cast<int32_t*>(smp);
  s.l = static_cast<const long long*>(l);
  s.cum = static_cast<const long long*>(cum);
  s.B = B;
  s.cap = cap;
  s.S = NS;
  s.hist = static_cast<int32_t*>(hist);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kDsa:
      launch_rows<kDsa>(v, s, st);
      break;
    case kLf:
      launch_rows<kLf>(v, s, st);
      break;
    default:
      launch_rows<kSlow>(v, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}
