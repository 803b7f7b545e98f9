// K9's partial, K13, K11's partial and the cross-rank walk steps: one
// rank's contribution when the S interval shards are spread over the ranks
// of a process group.
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
//                                       level_body (1075-1089);
//   walk steps  rs_walk_lf_step         do_walk's sampled-LF walk: a step
//                                       of fwalk (852-863), the terminal
//                                       pairs (866-875);
//               rs_walk_slow_step       do_walk's slow walk: a step of
//                                       walk (885-895) in two halves, the
//                                       read id of the $-rank (898).
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
// shards: C[code] on an active interval lane, the frozen bound on an
// inactive one, and a finished LF lane's raw value.  The all-reduce's
// output is the next step's input, and every step of the program (a
// search step, a LUT level, a walk step or half-step) is one launch and one
// all-reduce with nothing else between them.
//
// Each partial is written at the width of the JAX psum it stands for:
// int32 for the symbol, the read id of a $-rank, the sample, the dsa word
// (its 32 bits: one owner) and the raw LF value (its sign bit: one owner),
// and for the (read id, pair) triple; int64 for the ranks and the (LF, mark
// rank) pair.  The all-reduce moves those bytes and no more.
//
// The walk steps keep the walk's state on the card between launches and
// update it in place: cur (int64), done, steps or the offset at the $
// (int32).  A launch reads the previous all-reduce's output, advances the
// state, and writes this run's partial for the next all-reduce.  A lane
// that ends writes its terminal partial then (the LF walk's lf_mark
// entries, the slow walk's read id of its $-rank: drank is looked up where
// it is recorded), so an early exit after any step needs no further
// launch: the next all-reduce is the terminal's.  A lane that is done
// reads nothing more and writes 0; the JAX program's further lookups for
// it feed no answer.  Where early exit is asked for, each launch reports
// whether any lane is still live: one block a step stores the launch's
// sequence number into the walk's own mapped host word (the atomicMax on
// the walk's device word picks the block), which the host reads after one
// stream sync.
//
// What bounds each entry: a search step, a walk step and a K13 lookup read
// one row (or entry) a lane after its inputs, a chain of two dependent
// reads of ~0.25-0.6 us each, against a few MB a step (bytes bound a few
// us at 3.35 TB/s).  So the design removes what stood ahead of the first
// read (the run's key ranges come in the kernel's parameters, read at one
// index across the warp from the constant bank: no staging and no barrier),
// and sizes the blocks (256 threads down to 32) so that at least two land
// on every SM: a search step of 8192 queries fills the 132 SMs with blocks
// of 32.  One thread a lane; a search step's thread carries both bounds of
// its query, so its output may overwrite its input.
//
// Plain C interface (ctypes), the caller's stream, cudaGetLastError() or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"
#include "shard_view.cuh"

namespace {

using rs::ShardView;

constexpr int kMaxShards = 64;
constexpr int kMaxThreads = 256;

// The run's key boundaries (ops/sharded.py's RunKeys mirrors it): shard s of
// the run holds [b[s], b[s + 1]) of each kind of key, an empty shard b[s] ==
// b[s + 1]; kinds without a tier hold zeros.
struct RunKeys {
  long long S;
  long long pos[kMaxShards + 1];   // BWT positions
  long long dol[kMaxShards + 1];   // $-ranks
  long long rid[kMaxShards + 1];   // read ids
  long long slot[kMaxShards + 1];  // mark ranks (the sample pairs)
};

// K13's lookups, numbered as ops/sharded.py's LOOKUPS.
enum Lookup {
  kSym = 0,
  kDollar = 1,
  kSample = 2,
  kDsa = 3,
  kLf = 4,
  kLfMark = 5,      // int64 out [2X]: lf, then the mark rank
  kDollarPair = 6,  // int32 out [3X]: the read id, then (read id, offset)
};

// The walk steps' modes, numbered as ops/sharded.py's WALK_MODES.
enum Mode {
  kFirst = 0,     // set the state from the rows; write the first partial
  kStep = 1,      // advance from the reduced partial; write the next one
  kLast = 2,      // advance from the reduced partial; write none
  kRank = 3,      // slow walk, second half: the rank of the reduced symbol
  kTerminal = 4,  // LF walk: the (read id, pair) partial of the ended lanes
  kFinish = 5,    // read ids and offsets; the sample partial of the ids
};

// One walk's state and buffers (ops/sharded.py's WalkBuffers mirrors it):
// every field 8 bytes.
struct Walk {
  long long X, lead;
  const long long* rows;
  const bool* valid;
  long long* cur;
  bool* done;
  int32_t* count;     // LF: steps taken; slow: the step of the $, or -1
  int32_t* step32;    // the int32 partial of a step, reduced in place; the
                      // sample partial after kFinish
  long long* step64;  // slow: the rank partial of kRank
  long long* term64;  // LF: [2X] the lf_mark partial, written as lanes end
  int32_t* term32;    // LF: [3X] the (read id, pair) partial of kTerminal;
                      // slow: [X] the read id of the $-rank, as lanes end
  int32_t* read_id;
  int32_t* offset;
  unsigned long long* seen;  // device word: the last sequence reported
  unsigned long long* live;  // mapped host word
};

// The shard of the run whose range of b holds x, and x's offset there; -1
// where none does.  The scan reads b at one index across the warp (a
// broadcast from the parameter bank) and keeps the start it passes, so no
// lane reads b at an index of its own.
__device__ __forceinline__ int owner(const long long* b, int S, long long x,
                                     long long& loc) {
  if (x < b[0] || x >= b[S]) return -1;
  int s = 0;
  long long at = b[0];
  for (int j = 1; j < S; ++j) {
    const long long bj = b[j];
    if (bj > x) break;
    s = j;
    at = bj;
  }
  loc = x - at;
  return s;
}

template <class T>
__device__ __forceinline__ T chunk_at(const T* chunk, long long stride,
                                      const long long* b, int S, long long x) {
  long long loc = 0;
  const int s = owner(b, S, x, loc);
  return s < 0 ? T(0) : __ldg(chunk + s * stride + loc);
}

__device__ __forceinline__ int32_t sym_at(const ShardView& v,
                                          const RunKeys& k, long long i) {
  long long loc = 0;
  const int s = owner(k.pos, static_cast<int>(k.S), i, loc);
  if (s < 0) return 0;
  const uint32_t w = __ldg(v.sym4 + s * v.sym4_stride + (loc >> 3));
  return static_cast<int32_t>((w >> ((loc & 7) << 2)) & 0xFu);
}

__device__ __forceinline__ int2 pair_at(const ShardView& v, const RunKeys& k,
                                        long long slot) {
  long long loc = 0;
  const int s = owner(k.slot, static_cast<int>(k.S), slot, loc);
  if (s < 0) return make_int2(0, 0);
  return __ldg(reinterpret_cast<const int2*>(v.spairs) + s * v.spairs_stride +
               loc);
}

// The sample of read id clip(r, 0, m - 1), 0 where the run has not its id.
__device__ __forceinline__ int32_t sample_at(const ShardView& v,
                                             const RunKeys& k, long long r) {
  const long long hi = v.num_reads > 0 ? v.num_reads - 1 : 0;
  r = r < 0 ? 0 : (r > hi ? hi : r);
  return chunk_at(v.sample, v.sample_stride, k.rid, static_cast<int>(k.S), r);
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

// The run's partial rank of plane c before global position i: the prefix
// and the owner's row are read together.
__device__ __forceinline__ long long partial_rank(const RunKeys& k,
                                                  const Table& t,
                                                  const rs::Layout& g, int c,
                                                  long long i) {
  const int S = static_cast<int>(k.S);
  if (i <= k.pos[0]) return 0;
  if (i >= k.pos[S]) {
    return __ldg(t.prefix + static_cast<long long>(S) * t.planes + c);
  }
  long long loc = 0;
  const int s = owner(k.pos, S, i, loc);  // a nonempty shard holds i
  return __ldg(t.prefix + static_cast<long long>(s) * t.planes + c) +
         rs::occ_row(t.rows + s * t.stride, t.planes == 1 ? 0 : c,
                     static_cast<int32_t>(loc), g);
}

// Every thread of the block calls it once: the first block of this launch
// with a live lane stores seq into the host word.
__device__ __forceinline__ void report_live(const Walk& w, bool any,
                                            unsigned long long seq) {
  if (__syncthreads_or(any) && threadIdx.x == 0 &&
      atomicMax(w.seen, seq) < seq) {
    *reinterpret_cast<volatile unsigned long long*>(w.live) = seq;
  }
}

#define RS_LANES(x, X)                                                    \
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x +   \
                     threadIdx.x;                                         \
       x < (X); x += static_cast<long long>(gridDim.x) * blockDim.x)

// ------------------------------------------------------------ K9 partial

// K == 0: out[x] = the partial rank of plane c[x] before in[x] (X lanes).
// K > 0: one search step of k columns from column `col` over X queries
// (c: the codes [X, K]; in: the reduced (l, u) [2X]; out: [2X], may be in):
// the plane is the columns' codes less 1 in base 4 (k > 1) or the code
// itself (k = 1); a lane is active where l < u, its codes are bases (any
// plane for k = 1), and, with lengths, col >= K - lengths[x].  Active: the
// partial ranks, plus C_k[plane] on the lead rank; inactive: l and u on the
// lead rank, 0 elsewhere.
__global__ void __launch_bounds__(kMaxThreads)
    occ_partial_kernel(ShardView v, __grid_constant__ const RunKeys k,
                       int which, const int32_t* __restrict__ c,
                       const int32_t* __restrict__ lengths, int K, int col,
                       int kk, int lead, const long long* in, long long X,
                       long long* out) {
  const Table t = table_of(v, which);
  const rs::Layout g = layout_of(v, t.planes);
  RS_LANES(x, X) {
    if (K == 0) {
      out[x] = partial_rank(k, t, g, c[x], in[x]);
      continue;
    }
    const int32_t* q = c + x * K + col;
    int code = 0;
    bool ok = true;
    if (kk == 1) {
      code = q[0];
      ok = code >= 0 && code < t.planes;
    } else {
      for (int j = 0; j < kk; ++j) {
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
      nl = base + partial_rank(k, t, g, code, l);
      nu = base + partial_rank(k, t, g, code, u);
    }
    out[x] = nl;
    out[X + x] = nu;
  }
}

// ------------------------------------------------------------------ K13

__global__ void __launch_bounds__(kMaxThreads)
    lookup_partial_kernel(ShardView v, __grid_constant__ const RunKeys k,
                          int what, const long long* __restrict__ in,
                          const long long* __restrict__ in2, long long X,
                          void* out) {
  const int S = static_cast<int>(k.S);
  int32_t* o32 = static_cast<int32_t*>(out);
  long long* o64 = static_cast<long long*>(out);
  RS_LANES(x, X) {
    const long long key = in[x];
    switch (what) {
      case kSym:
        o32[x] = sym_at(v, k, key);
        break;
      case kDollar:
        o32[x] = chunk_at(v.dollar, v.dollar_stride, k.dol, S, key);
        break;
      case kSample:
        o32[x] = sample_at(v, k, key);
        break;
      case kDsa:  // the uint32 word's bits
        o32[x] = static_cast<int32_t>(
            chunk_at(v.dsa, v.dsa_stride, k.pos, S, key));
        break;
      case kLf:  // the raw LF value, its sign bit kept
        o32[x] = chunk_at(v.lf, v.lf_stride, k.pos, S, key);
        break;
      case kLfMark:
        o64[x] = chunk_at(v.lf, v.lf_stride, k.pos, S, key);
        o64[X + x] = partial_rank(k, table_of(v, 3), layout_of(v, 1), 0, key);
        break;
      default: {  // kDollarPair
        const int2 p = pair_at(v, k, in2[x]);
        o32[x] = chunk_at(v.dollar, v.dollar_stride, k.dol, S, key);
        o32[X + 2 * x] = p.x;
        o32[X + 2 * x + 1] = p.y;
      }
    }
  }
}

// ----------------------------------------------------------- K11 partial

// Level l's X intervals → level l + 1's partial, c-major: the lower bounds
// at (c - 1) * stride + x, the upper ones 4 * stride after them.
__global__ void __launch_bounds__(kMaxThreads)
    lut_level_partial_kernel(ShardView v, __grid_constant__ const RunKeys k,
                             const long long* __restrict__ l_in,
                             const long long* __restrict__ u_in, long long X,
                             int lead, long long* __restrict__ out,
                             long long stride) {
  const Table t = table_of(v, 0);
  const rs::Layout g = layout_of(v, 5);
  RS_LANES(x, X) {
    const long long l = l_in[x];
    const long long u = u_in[x];
    const bool alive = l < u;
#pragma unroll
    for (int c = 1; c <= 4; ++c) {
      long long nl = lead ? l : 0, nu = lead ? u : 0;
      if (alive) {
        const long long base = lead ? __ldg(v.C + c) : 0;
        nl = base + partial_rank(k, t, g, c, l);
        nu = base + partial_rank(k, t, g, c, u);
      }
      out[(c - 1) * stride + x] = nl;
      out[(c + 3) * stride + x] = nu;
    }
  }
}

// ------------------------------------------------------------ walk steps

// The sampled-LF walk (do_walk's fwalk and its terminal).  kFirst: cur =
// rows, done = !valid, steps = 0, the lf_mark partial cleared.  kStep and
// kLast, on a live lane, from the reduced raw LF of cur: an end (sign bit
// set, or a value below m) marks the lane done and writes its lf_mark
// partial (the raw value on the lead rank; the run's mark rank of cur where
// the row is sampled, the only case that reads it); else cur = the value
// and steps + 1.  kFirst and kStep then write the run's raw LF of each live
// lane's cur.  kTerminal, on a valid ended lane, from the reduced lf_mark:
// the read id of the $-rank (an unsampled end) or the sample pair at the
// mark rank (a sampled one).  kFinish: the read id and offset (pair id and
// offset + steps, or the $'s read id and steps), -1 where the lane is
// invalid or did not end, and the sample partial of each id.
__global__ void __launch_bounds__(kMaxThreads)
    lf_step_kernel(ShardView v, __grid_constant__ const RunKeys k, Walk w,
                   int mode, unsigned long long seq) {
  const int S = static_cast<int>(k.S);
  const long long X = w.X;
  bool any = false;
  RS_LANES(x, X) {
    if (mode == kTerminal) {
      int32_t rid = 0;
      int2 p = make_int2(0, 0);
      if (w.valid[x] && w.done[x]) {
        const int32_t raw = static_cast<int32_t>(w.term64[x]);
        if (raw < 0) {
          p = pair_at(v, k, w.term64[X + x]);
        } else {
          rid = chunk_at(v.dollar, v.dollar_stride, k.dol, S,
                         static_cast<long long>(raw & 0x7FFFFFFF));
        }
      }
      w.term32[x] = rid;
      w.term32[X + 2 * x] = p.x;
      w.term32[X + 2 * x + 1] = p.y;
      continue;
    }
    if (mode == kFinish) {
      int32_t rid = -1, off = -1;
      if (w.valid[x] && w.done[x]) {
        const int32_t steps = w.count[x];
        if (static_cast<int32_t>(w.term64[x]) < 0) {
          rid = w.term32[X + 2 * x];
          off = w.term32[X + 2 * x + 1] + steps;
        } else {
          rid = w.term32[x];
          off = steps;
        }
      }
      w.read_id[x] = rid;
      w.offset[x] = off;
      w.step32[x] = sample_at(v, k, rid);
      continue;
    }
    long long cur = 0;
    bool d;
    if (mode == kFirst) {
      cur = w.rows[x];
      d = !w.valid[x];
      w.cur[x] = cur;
      w.done[x] = d;
      w.count[x] = 0;
      w.term64[x] = 0;
      w.term64[X + x] = 0;
    } else {
      d = w.done[x];
      if (!d) {
        cur = w.cur[x];
        const int32_t raw = w.step32[x];
        const long long val = raw & 0x7FFFFFFF;
        if (raw < 0 || val < v.num_reads) {
          d = true;
          w.done[x] = true;
          w.term64[x] = w.lead ? raw : 0;
          if (raw < 0) {
            w.term64[X + x] =
                partial_rank(k, table_of(v, 3), layout_of(v, 1), 0, cur);
          }
        } else {
          cur = val;
          w.cur[x] = val;
          w.count[x] += 1;
        }
      }
    }
    any = any || !d;
    if (mode != kLast) {
      w.step32[x] = d ? 0 : chunk_at(v.lf, v.lf_stride, k.pos, S, cur);
    }
  }
  if (mode == kFirst || mode == kStep) report_live(w, any, seq);
}

// The slow walk (do_walk's walk and the read id of its $-rank).  kFirst:
// cur = rows, done = !valid, offset = -1, the $'s read-id partial cleared;
// then the run's symbol at each live lane's cur.  kRank (the second half of
// step t), from the reduced symbol c: the run's partial rank of c before
// cur on each live lane.  kStep and kLast (its first half, step t), from
// the reduced c and rank o of a live lane: c = $ ends the lane (offset = t,
// and the run's read id of $-rank o written now), else cur = C[c] + o;
// kStep then writes the run's symbol at each live lane's new cur.
// kFinish: the read id and offset, -1 where the lane is invalid or did not
// end, and the sample partial of each id.
__global__ void __launch_bounds__(kMaxThreads)
    slow_step_kernel(ShardView v, __grid_constant__ const RunKeys k, Walk w,
                     int mode, int t, unsigned long long seq) {
  const int S = static_cast<int>(k.S);
  bool any = false;
  RS_LANES(x, w.X) {
    if (mode == kFinish) {
      const bool ok = w.valid[x] && w.done[x];
      const int32_t rid = ok ? w.term32[x] : -1;
      w.read_id[x] = rid;
      w.offset[x] = ok ? w.count[x] : -1;
      w.step32[x] = sample_at(v, k, rid);
      continue;
    }
    if (mode == kRank) {
      w.step64[x] =
          w.done[x] ? 0
                    : partial_rank(k, table_of(v, 0), layout_of(v, 5),
                                   w.step32[x], w.cur[x]);
      continue;
    }
    long long cur = 0;
    bool d;
    if (mode == kFirst) {
      cur = w.rows[x];
      d = !w.valid[x];
      w.cur[x] = cur;
      w.done[x] = d;
      w.count[x] = -1;
      w.term32[x] = 0;
    } else {
      d = w.done[x];
      if (!d) {
        const int32_t c = w.step32[x];
        const long long o = w.step64[x];
        if (c == 0) {
          d = true;
          w.done[x] = true;
          w.count[x] = t;
          w.term32[x] = chunk_at(v.dollar, v.dollar_stride, k.dol, S, o);
        } else {
          cur = __ldg(v.C + c) + o;
          w.cur[x] = cur;
        }
      }
    }
    any = any || !d;
    if (mode != kLast) w.step32[x] = d ? 0 : sym_at(v, k, cur);
  }
  if (mode == kFirst || mode == kStep) report_live(w, any, seq);
}

#undef RS_LANES

// The card's SM count, read once per device.
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 1;
  }
  return cached[dev];
}

// One thread a lane, in blocks of 256 threads or, where that leaves fewer
// than two blocks an SM, of 128, 64 or 32; grid-stride past 2^20 blocks.
struct Shape {
  unsigned blocks;
  int threads;
};

Shape shape_for(long long n) {
  const long long want = 2LL * sm_count();
  int threads = kMaxThreads;
  while (threads > 32 && (n + threads - 1) / threads < want) threads >>= 1;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  return {static_cast<unsigned>(blocks > 0 ? blocks : 1), threads};
}

bool view_ok(const ShardView& v, const RunKeys& k) {
  return v.S >= 1 && v.S <= kMaxShards && k.S == v.S && v.rank != nullptr &&
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

bool walk_ok(const Walk& w) {
  return w.rows != nullptr && w.valid != nullptr && w.cur != nullptr &&
         w.done != nullptr && w.count != nullptr && w.step32 != nullptr &&
         w.term32 != nullptr && w.read_id != nullptr &&
         w.offset != nullptr && w.seen != nullptr && w.live != nullptr;
}

}  // namespace

// K9 partial: K == 0, the run's partial rank over table `which` (0 base,
// 1 pair, 2 triple, 3 marks) of plane c[x] (int32) before in[x] (int64),
// X lanes; K in [1, 256], a search step over X queries of table which = k - 1
// from column col (see occ_partial_kernel; out may be in).  view: an
// ops/sharded.ShardView, keys: its RunKeys.
extern "C" int rs_shard_occ_partial(const void* view, const void* keys,
                                    int which, const void* c,
                                    const void* lengths, int K, int col, int k,
                                    int lead, const void* in, long long X,
                                    void* out, void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const RunKeys& rk = *static_cast<const RunKeys*>(keys);
  const bool step_ok =
      K == 0 || (K >= 1 && K <= 256 && k >= 1 && k <= 3 && which == k - 1 &&
                 col >= 0 && col + k <= K);
  if (!view_ok(v, rk) || !has_table(v, which) || !step_ok || c == nullptr ||
      in == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Shape sh = shape_for(X);
  occ_partial_kernel<<<sh.blocks, sh.threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      v, rk, which, static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(lengths), K, col, k, lead != 0,
      static_cast<const long long*>(in), X, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K13: lookup `what` (see Lookup) of keys in[x] (int64; in2: the mark-rank
// slots of kDollarPair) over the run's shards, 0 where none owns the key
// → out int32 [X] ([3X] kDollarPair), int64 [2X] for kLfMark.
extern "C" int rs_shard_lookup_partial(const void* view, const void* keys,
                                       int what, const void* in,
                                       const void* in2, long long X, void* out,
                                       void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const RunKeys& rk = *static_cast<const RunKeys*>(keys);
  bool ok = view_ok(v, rk) && in != nullptr && out != nullptr;
  switch (what) {
    case kSym: ok = ok && v.sym4 != nullptr; break;
    case kDollar: ok = ok && v.dollar != nullptr; break;
    case kSample: ok = ok && v.sample != nullptr; break;
    case kDsa: ok = ok && v.dsa != nullptr; break;
    case kLf: ok = ok && v.lf != nullptr; break;
    case kLfMark: ok = ok && v.lf != nullptr && has_table(v, 3); break;
    case kDollarPair:
      ok = ok && in2 != nullptr && v.dollar != nullptr && v.spairs != nullptr;
      break;
    default: ok = false;
  }
  if (!ok) return cudaErrorInvalidValue;
  const Shape sh = shape_for(X);
  lookup_partial_kernel<<<sh.blocks, sh.threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      v, rk, what, static_cast<const long long*>(in),
      static_cast<const long long*>(in2), X, out);
  return static_cast<int>(cudaGetLastError());
}

// K11 partial: level l's X intervals (int64) → level l + 1's partials, the
// lower bounds of plane c at out[(c - 1) * stride + x], the upper ones at
// out[(c + 3) * stride + x].
extern "C" int rs_sharded_lut_level_partial(const void* view, const void* keys,
                                            const void* l, const void* u,
                                            long long X, int lead, void* out,
                                            long long stride, void* stream) {
  if (X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const RunKeys& rk = *static_cast<const RunKeys*>(keys);
  if (!view_ok(v, rk) || l == nullptr || u == nullptr || out == nullptr ||
      stride < X) {
    return cudaErrorInvalidValue;
  }
  const Shape sh = shape_for(X);
  lut_level_partial_kernel<<<sh.blocks, sh.threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      v, rk, static_cast<const long long*>(l),
      static_cast<const long long*>(u), X, lead != 0,
      static_cast<long long*>(out), stride);
  return static_cast<int>(cudaGetLastError());
}

// The sampled-LF walk's step `mode` (see Mode, lf_step_kernel) over the
// walk `walk` (a WalkBuffers: X lanes, term64 [2X], term32 [3X]); seq: the
// launch's sequence number, stored into walk->live where a lane is live
// after a kFirst or kStep launch.
extern "C" int rs_walk_lf_step(const void* view, const void* keys,
                               const void* walk, int mode,
                               unsigned long long seq, void* stream) {
  const Walk& w = *static_cast<const Walk*>(walk);
  if (w.X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const RunKeys& rk = *static_cast<const RunKeys*>(keys);
  if (!view_ok(v, rk) || !walk_ok(w) || w.term64 == nullptr ||
      v.lf == nullptr || v.dollar == nullptr || v.spairs == nullptr ||
      v.sample == nullptr || !has_table(v, 3) || mode < kFirst ||
      mode > kFinish || mode == kRank) {
    return cudaErrorInvalidValue;
  }
  const Shape sh = shape_for(w.X);
  lf_step_kernel<<<sh.blocks, sh.threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(v, rk, w, mode, seq);
  return static_cast<int>(cudaGetLastError());
}

// The slow walk's step `mode` at step t (see Mode, slow_step_kernel) over
// `walk` (X lanes, step64 [X], term32 [X]); seq as rs_walk_lf_step's.
extern "C" int rs_walk_slow_step(const void* view, const void* keys,
                                 const void* walk, int mode, int t,
                                 unsigned long long seq, void* stream) {
  const Walk& w = *static_cast<const Walk*>(walk);
  if (w.X <= 0) return 0;
  const ShardView& v = *static_cast<const ShardView*>(view);
  const RunKeys& rk = *static_cast<const RunKeys*>(keys);
  if (!view_ok(v, rk) || !walk_ok(w) || w.step64 == nullptr ||
      v.sym4 == nullptr || v.dollar == nullptr || v.sample == nullptr ||
      mode < kFirst || mode > kFinish || mode == kTerminal || t < 0) {
    return cudaErrorInvalidValue;
  }
  const Shape sh = shape_for(w.X);
  slow_step_kernel<<<sh.blocks, sh.threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(v, rk, w, mode, t,
                                                          seq);
  return static_cast<int>(cudaGetLastError());
}

// A word of pinned host memory the card writes through its mapping (the
// walks' live flag), zeroed: *host for the host, *dev for the kernels.
extern "C" int rs_host_word(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, sizeof(unsigned long long),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<unsigned long long*>(*host) = 0;
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int rs_host_word_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}
