// K9's partial, K13 and K11's partial: one rank's contribution when the S
// interval shards are spread over the ranks of a process group.
//
// Replaces the device code of readserver_tpu/parallel/sharded.py where a
// shard is a device of the 'shard' mesh axis and a psum over that axis
// merges the shards' masked contributions at every step:
//   K9 partial  rs_shard_occ_partial    _ShardLocal.occ_global and
//                                       occ_plane_global (395-422),
//                                       mark_rank_global (545), and a
//                                       search step of _query_body
//                                       (700-797) or its rank alone;
//   K13         rs_shard_lookup_partial sym_global (489), dollar_global
//                                       (501), sample_global (510),
//                                       dsa_global (522), lf_raw_global
//                                       (532), and the two fused pairs
//                                       lf_and_mark_global (574) and
//                                       dollar_and_pair_global (599);
//   K11 partial rs_sharded_lut_level_partial
//                                       build_prefix_lut_sharded's
//                                       level_body (1075-1089).
//
// A rank holds a contiguous run of the shards on its own device: its view
// has S = the run's length, the shards' global starts, and the exclusive
// prefixes of the totals over the run's own shards (row S: the run's
// totals).  The ranks of one dp row sum their partials by one all-reduce a
// step (parallel/sharded.py).  A partial is the JAX masked sum over the
// run's shards only:
//   rank(c, i) = Σ_{s in run} occ_s(c, clamp(i - start_s, 0, len_s)),
//   0 for i at or below the run's first position, the run's totals at or
//   past its end, else prefix[s][c] + occ_s(c, i - start_s) at the owner s
//   (one row read where the JAX program reads one a shard);
//   a lookup is the owning shard's entry, or 0 where no shard of the run
//   owns the key (at most one rank of the row owns it, so the sum is the
//   entry, its sign bit included).
// The lead rank (shard coordinate 0) also adds what is not a sum over
// shards: C[code] on an active interval lane and the frozen bound on an
// inactive one.  The all-reduce's output is then the next interval, and a
// search step or a LUT level is one launch and one all-reduce with no
// other work between them.
//
// Each kernel is one thread per lane, grid-stride, the run's key ranges
// staged in shared memory and an owner found by a binary search of them.
// Plain C interface (ctypes), the caller's stream, cudaGetLastError() or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"
#include "shard_view.cuh"

namespace {

using rs::ShardView;

constexpr int kMaxShards = 64;
constexpr int kThreads = 128;

// K13's lookups, numbered as ops/sharded.py's LOOKUPS.
enum Lookup {
  kSym = 0,
  kDollar = 1,
  kSample = 2,
  kDsa = 3,
  kLf = 4,
  kLfMark = 5,      // out [2X]: lf, then the mark rank
  kDollarPair = 6,  // out [3X]: the read id, then (read id, offset) pairs
};

// The run's ranges of one kind of key, sorted, not overlapping; an empty
// range has start == end.
struct Ranges {
  long long start[kMaxShards], end[kMaxShards];
};

// Every thread of the block calls it; the caller's __syncthreads orders the
// stores.  Null keys stage empty ranges.
__device__ __forceinline__ void stage(Ranges& r, const long long* starts,
                                      const long long* lens, int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long a = starts != nullptr ? starts[s] : 0;
    r.start[s] = a;
    r.end[s] = starts != nullptr ? a + lens[s] : a;
  }
}

// The last range starting at or before x, -1 when none: of ranges with one
// start (empty ones before a nonempty one) the last.
__device__ __forceinline__ int owner(const Ranges& r, int S, long long x) {
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

struct Table {
  const uint32_t* rows;
  long long stride;
  const long long* prefix;  // [S + 1, planes]
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

__device__ __forceinline__ const long long* starts_of(const ShardView& v,
                                                      int which) {
  return which == 2 ? v.C3 : (which == 1 ? v.C2 : v.C);
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

// The run's partial rank of plane c before global position i.
__device__ __forceinline__ long long partial_rank(const Ranges& pos, int S,
                                                  const Table& t,
                                                  const rs::Layout& g, int c,
                                                  long long i) {
  if (i <= pos.start[0]) return 0;
  if (i >= pos.end[S - 1]) {
    return __ldg(t.prefix + static_cast<long long>(S) * t.planes + c);
  }
  const int s = owner(pos, S, i);  // a nonempty shard: i lies inside it
  return __ldg(t.prefix + static_cast<long long>(s) * t.planes + c) +
         rs::occ_row(t.rows + s * t.stride, t.planes == 1 ? 0 : c,
                     static_cast<int32_t>(i - pos.start[s]), g);
}

// ------------------------------------------------------------ K9 partial

// K == 0: out[x] = the partial rank of plane c[x] before in[x] (X lanes).
// K > 0: one search step of k columns from column `col` over X queries
// (c: the codes [X, K]; in: the reduced (l, u) [2X]; out: [2X]): the plane
// is the columns' codes less 1 in base 4 (k > 1) or the code itself (k = 1);
// a lane is active where l < u, its codes are bases (any plane for k = 1),
// and, with lengths, col >= K - lengths[x].  Active: the partial ranks,
// plus C_k[plane] on the lead rank; inactive: l and u on the lead rank, 0
// elsewhere.
__global__ void __launch_bounds__(kThreads)
    occ_partial_kernel(ShardView v, int which, const int32_t* __restrict__ c,
                       const int32_t* __restrict__ lengths, int K, int col,
                       int k, int lead, const long long* __restrict__ in,
                       long long X, long long* __restrict__ out) {
  __shared__ Ranges pos;
  const int S = static_cast<int>(v.S);
  stage(pos, v.starts, v.lens, S);
  __syncthreads();
  const Table t = table_of(v, which);
  const rs::Layout g = layout_of(v, t.planes);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < X; x += step) {
    if (K == 0) {
      out[x] = partial_rank(pos, S, t, g, c[x], in[x]);
      continue;
    }
    const int32_t* q = c + x * K + col;
    int code = 0;
    bool ok = true;
    if (k == 1) {
      code = q[0];
      ok = code >= 0 && code < t.planes;
    } else {
      for (int j = 0; j < k; ++j) {
        const int32_t a = q[j];
        ok = ok && a >= 1 && a <= 4;
        code = code * 4 + (a - 1);
      }
    }
    const long long l = in[x], u = in[X + x];
    const bool active = ok && l < u &&
                        (lengths == nullptr || col >= K - lengths[x]);
    long long nl = lead ? l : 0, nu = lead ? u : 0;
    if (active) {
      const long long base = lead ? __ldg(starts_of(v, which) + code) : 0;
      nl = base + partial_rank(pos, S, t, g, code, l);
      nu = base + partial_rank(pos, S, t, g, code, u);
    }
    out[x] = nl;
    out[X + x] = nu;
  }
}

// ------------------------------------------------------------------ K13

__global__ void __launch_bounds__(kThreads)
    lookup_partial_kernel(ShardView v, int what,
                          const long long* __restrict__ in,
                          const long long* __restrict__ in2, long long X,
                          long long* __restrict__ out) {
  __shared__ Ranges pos, dol, rid, slot;
  const int S = static_cast<int>(v.S);
  stage(pos, v.starts, v.lens, S);
  stage(dol, v.dstarts, v.dlens, S);
  stage(rid, v.rstarts, v.rlens, S);
  stage(slot, v.sstarts, v.slens, S);
  __syncthreads();
  const Table marks = table_of(v, 3);
  const rs::Layout g = layout_of(v, 1);
  const long long hi = v.num_reads > 0 ? v.num_reads - 1 : 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < X; x += step) {
    long long key = in[x], loc = 0, r = 0;
    int s;
    switch (what) {
      case kSym:
        s = owned(pos, S, key, loc);
        if (s >= 0) {
          const uint32_t w = __ldg(v.sym4 + s * v.sym4_stride + (loc >> 3));
          r = (w >> ((loc & 7) << 2)) & 0xFu;
        }
        break;
      case kDollar:
      case kDollarPair:
        s = owned(dol, S, key, loc);
        if (s >= 0) r = __ldg(v.dollar + s * v.dollar_stride + loc);
        break;
      case kSample:
        key = key < 0 ? 0 : (key > hi ? hi : key);
        s = owned(rid, S, key, loc);
        if (s >= 0) r = __ldg(v.sample + s * v.sample_stride + loc);
        break;
      case kDsa:
        s = owned(pos, S, key, loc);
        if (s >= 0) r = __ldg(v.dsa + s * v.dsa_stride + loc);  // uint32
        break;
      default:  // kLf, kLfMark: the raw LF value, its sign bit kept
        s = owned(pos, S, key, loc);
        if (s >= 0) r = __ldg(v.lf + s * v.lf_stride + loc);
    }
    out[x] = r;
    if (what == kLfMark) {
      out[X + x] = partial_rank(pos, S, marks, g, 0, key);
    } else if (what == kDollarPair) {
      int2 p = make_int2(0, 0);
      s = owned(slot, S, in2[x], loc);
      if (s >= 0) {
        p = __ldg(reinterpret_cast<const int2*>(v.spairs) +
                  s * v.spairs_stride + loc);
      }
      out[X + 2 * x] = p.x;
      out[X + 2 * x + 1] = p.y;
    }
  }
}

// ----------------------------------------------------------- K11 partial

// Level l's X intervals → level l + 1's partial, c-major: the lower bounds
// at (c - 1) * stride + x, the upper ones 4 * stride after them.
__global__ void __launch_bounds__(kThreads)
    lut_level_partial_kernel(ShardView v, const long long* __restrict__ l_in,
                             const long long* __restrict__ u_in, long long X,
                             int lead, long long* __restrict__ out,
                             long long stride) {
  __shared__ Ranges pos;
  const int S = static_cast<int>(v.S);
  stage(pos, v.starts, v.lens, S);
  __syncthreads();
  const Table t = table_of(v, 0);
  const rs::Layout g = layout_of(v, 5);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       x < X; x += step) {
    const long long l = l_in[x];
    const long long u = u_in[x];
    const bool alive = l < u;
#pragma unroll
    for (int c = 1; c <= 4; ++c) {
      long long nl = lead ? l : 0, nu = lead ? u : 0;
      if (alive) {
        const long long base = lead ? __ldg(v.C + c) : 0;
        nl = base + partial_rank(pos, S, t, g, c, l);
        nu = base + partial_rank(pos, S, t, g, c, u);
      }
      out[(c - 1) * stride + x] = nl;
      out[(c + 3) * stride + x] = nu;
    }
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

bool view_ok(const ShardView& v) {
  return v.S >= 1 && v.S <= kMaxShards && v.starts != nullptr &&
         v.lens != nullptr && v.rank != nullptr &&
         v.rank_prefix != nullptr && v.C != nullptr &&
         v.words_per_block >= 1 && v.row_words >= v.words_per_block + 1 &&
         (v.words_per_block << 5) == (1LL << v.log2_block);
}

bool has_table(const ShardView& v, int which) {
  switch (which) {
    case 0: return true;
    case 1: return v.rank2 != nullptr && v.rank2_prefix != nullptr &&
                   v.C2 != nullptr;
    case 2: return v.rank3 != nullptr && v.rank3_prefix != nullptr &&
                   v.C3 != nullptr;
    case 3: return v.marks != nullptr && v.mark_prefix != nullptr;
    default: return false;
  }
}

}  // namespace

// K9 partial: K == 0, the run's partial rank over table `which` (0 base,
// 1 pair, 2 triple, 3 marks) of plane c[x] (int32) before in[x] (int64),
// X lanes; K in [1, 256], a search step over X queries of table which = k - 1
// from column col (see occ_partial_kernel).
extern "C" int rs_shard_occ_partial(const void* view, int which,
                                    const void* c, const void* lengths, int K,
                                    int col, int k, int lead, const void* in,
                                    long long X, void* out, void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const bool step_ok =
      K == 0 || (K >= 1 && K <= 256 && k >= 1 && k <= 3 && which == k - 1 &&
                 col >= 0 && col + k <= K);
  if (!view_ok(v) || !has_table(v, which) || !step_ok || c == nullptr ||
      in == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  occ_partial_kernel<<<grid_for(X), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      v, which, static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(lengths), K, col, k, lead != 0,
      static_cast<const long long*>(in), X, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K13: lookup `what` (see Lookup) of keys in[x] (int64; in2: the mark-rank
// slots of kDollarPair) over the run's shards, 0 where none owns the key
// → out int64 [X] ([2X] kLfMark, [3X] kDollarPair).
extern "C" int rs_shard_lookup_partial(const void* view, int what,
                                       const void* in, const void* in2,
                                       long long X, void* out, void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  bool ok = view_ok(v) && in != nullptr && out != nullptr;
  switch (what) {
    case kSym: ok = ok && v.sym4 != nullptr; break;
    case kDollar: ok = ok && v.dollar != nullptr && v.dstarts != nullptr; break;
    case kSample: ok = ok && v.sample != nullptr && v.rstarts != nullptr; break;
    case kDsa: ok = ok && v.dsa != nullptr; break;
    case kLf: ok = ok && v.lf != nullptr; break;
    case kLfMark: ok = ok && v.lf != nullptr && has_table(v, 3); break;
    case kDollarPair:
      ok = ok && in2 != nullptr && v.dollar != nullptr &&
           v.dstarts != nullptr && v.spairs != nullptr &&
           v.sstarts != nullptr;
      break;
    default: ok = false;
  }
  if (!ok) return cudaErrorInvalidValue;
  lookup_partial_kernel<<<grid_for(X), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      v, what, static_cast<const long long*>(in),
      static_cast<const long long*>(in2), X, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K11 partial: level l's X intervals (int64) → level l + 1's partials, the
// lower bounds of plane c at out[(c - 1) * stride + x], the upper ones at
// out[(c + 3) * stride + x].
extern "C" int rs_sharded_lut_level_partial(const void* view, const void* l,
                                            const void* u, long long X,
                                            int lead, void* out,
                                            long long stride, void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  if (!view_ok(v) || l == nullptr || u == nullptr || out == nullptr ||
      stride < X) {
    return cudaErrorInvalidValue;
  }
  lut_level_partial_kernel<<<grid_for(X), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const long long*>(l), static_cast<const long long*>(u),
      X, lead != 0, static_cast<long long*>(out), stride);
  return static_cast<int>(cudaGetLastError());
}
