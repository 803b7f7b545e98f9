// K5-K7 and the rank walks: resolve SA rows to (read id, offset), and exact
// per-sample histograms over whole query intervals.
//
// Replaces the XLA loops of readserver_tpu/ops/resolve.py, which the JAX
// package never wrote in Pallas:
//   K5 rs_resolve_dsa      expand_intervals (74) + resolve_rows_dsa (222)
//                          + the engine's read_to_sample gather
//                          (serve/engine.py:548-561);
//   K6 rs_resolve_fused    resolve_rows_fused + _fused_step_fields
//                          (258-342);
//   rs_resolve_walk        the walks that rank through K1's table layout
//                          (rank.cuh): resolve_rows_marked (165),
//                          resolve_rows_fast (91, the lf walk) and
//                          resolve_rows (24, the slow walk);
//   K7 rs_exact_histogram  exact_sample_histogram (426-499), through any of
//                          the five walks.
// The JAX lanes step in lockstep with frozen `done` lanes, one XLA gather (or
// K1 launch) per table a step; here a lane carries its row through the whole
// walk and stops at its terminal, which gives the same answers.  This is the
// fusion across steps that the TPU design ruled out
// (kernels/pallas_rank.py:23-27).
//
// What bounds them on the H100.  K5 is one random 4-byte read per hit lane:
// bytes.  The walks, and K7 through them, are chains of up to sample_rate
// (slow walk: max_steps) dependent row reads and one terminal read, over tens
// to hundreds of thousands of walks that share rows: the chain (one read's
// latency, ~0.25 us from L2, times the reads a walk makes) and the
// instructions each step issues, until the walks outnumber the lanes the
// card holds at once.  K7 through dsa is a short chain per slot (its query,
// its dsa word, its sample) and, at a full worklist, the rate of those reads.
//
// What the design does about it:
// - A persistent grid (occupancy x SMs; 64 registers a thread, so nothing
//   spills).  Warp w takes tiles w, w + nwarps, ... of consecutive slots,
//   so one query's neighbouring rows stay in one warp and share sectors.
//   No counter: claiming through one atomicAdd measured slower, its queue
//   standing in the walks' way.
// - The walks: tiles of 32, and lane refill: a lane whose walk ended takes
//   its warp's next slot, so lanes stay busy when the walks outnumber
//   resident threads.  Each iteration a lane issues the reads of its state
//   before any lane uses one: a walk's terminal read (its sampled pair or
//   dollar_map entry) and K7's read_to_sample read are lane states of their
//   own, issued beside the other lanes' row reads rather than after them.
//   C in registers.
// - The fused walk: one 64-byte row a step, W <= 2's bit planes as 64-bit
//   words, so a row's decode is a few shifts, masks and popcounts.
// - The marks and slow walks: while a warp's walks fit its lanes, one
//   round of independent 16-byte reads a step, the four base planes' rank
//   rows at the row's block (and for marks the mark row).  The five planes
//   partition the BWT, so the symbol is the base plane whose bit is set, or
//   $ when none is, and occ($, i) = i less the four base counts: a step is
//   one latency where the symbol read and the rank read of its plane would
//   be two.  Once walks queue for lanes the sweep is held by the rate of
//   sector reads, and a step takes those two rounds, the sym4 word (and
//   mark row), then the symbol's rank row: 3 sectors where one round reads
//   5.  Ranks count with rank.cuh's code, K1's own.
// - The lf walk: one 4-byte LF word a step; a sampled row's slot is its
//   mark row's rank, read as a state of its own.
// - K7 maps a tile's slots to (query, row) once: a 128-way search of the
//   int64 prefix sums for the tile's first query, then the sums and
//   interval starts the tile spans, staged in the warp's shared memory and
//   searched there.  Through dsa, a tile is 128 slots, four a lane, whose
//   dsa and read_to_sample reads go out four at a time.  The sweep's limit,
//   min(total, cap), is read on the card, so no launch waits for the host.
//
// rs_chase is a yardstick, not a kernel of any path: chains of dependent
// 64-byte reads through the fused table, each next row a hash of the words
// just loaded.  One warp of chains gives the card's unloaded time per row.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a layout it does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;   // persistent blocks of 4 warps
constexpr int kMinBlocks = 8;   // per SM: 64 registers a thread, no spill

// The walk kinds, numbered as the entry points take them.
enum WalkKind { kDsa = 0, kFused = 1, kMarks = 2, kLf = 3, kSlow = 4 };

// Everything a walk reads; each kind reads its own tables:
//   dsa:   one word per SA row;
//   fused: rows of fused_words uint32 words per block of (1 << log2_block)
//          symbols: [occ ckpt c=0..4, mark ckpt, dollar plane, base-low
//          plane, base-high plane, mark plane, pad]
//          (index/packing.pack_fused_rows);
//   marks, slow: the base rank table (rank.cuh's layout, planes c = 0..4)
//          and the sym4 words (8 symbols a word, 4 bits each);
//   marks, lf: the mark table, one plane of that layout (pack_bit_rank);
//   lf:    one int32 a row, the LF value with the sign bit set where sampled.
struct Walk {
  const uint32_t* dsa;
  int dsa_bits;
  const uint32_t* fused;
  int fused_words;
  const uint32_t* rank;
  const uint32_t* sym4;
  const uint32_t* marks;
  const int32_t* lf;
  rs::Layout layout;  // rank and marks; its log2_block is the fused rows' too
  const int32_t* C;
  const int32_t* dollar_map;
  long long n_dollar;
  const int32_t* pairs;  // [n_pairs, 2] (read id, offset)
  long long n_pairs;
  int max_steps;  // the walk's bound: sample_rate, or the slow walk's steps
};

__device__ __forceinline__ long long clip_index(long long i, long long n) {
  const long long hi = n > 0 ? n - 1 : 0;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// dsa[row] = read_id << bits | offset, a uint32: the shift is logical, so a
// word with bit 31 set (read ids past 2^(31 - bits)) still gives its id.
__device__ __forceinline__ void dsa_decode(const Walk& g, int32_t row,
                                           int32_t& rid, int32_t& off) {
  const uint32_t p = __ldg(g.dsa + row);
  rid = static_cast<int32_t>(p >> g.dsa_bits);
  off = static_cast<int32_t>(p & ((1u << g.dsa_bits) - 1u));
}

// One fused row in registers: R words, loaded as R / 4 16-byte vectors.
template <int W>
struct FusedRow {
  static constexpr int R = (6 + 4 * W + 3) / 4 * 4;
  static constexpr int DOLLAR = 6, LO = 6 + W, HI = 6 + 2 * W, MARK = 6 + 3 * W;
  uint32_t w[R];

  __device__ __forceinline__ void load(const uint32_t* row) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const uint4 x = __ldg(v + k);
      w[4 * k] = x.x;
      w[4 * k + 1] = x.y;
      w[4 * k + 2] = x.z;
      w[4 * k + 3] = x.w;
    }
  }

  // the plane starting at word OFF as one 64-bit word (W <= 2)
  template <int OFF>
  __device__ __forceinline__ uint64_t plane64() const {
    if constexpr (W == 1) {
      return w[OFF];
    } else {
      return (static_cast<uint64_t>(w[OFF + 1]) << 32) | w[OFF];
    }
  }

  // the bit at `within` of the plane at OFF
  template <int OFF>
  __device__ __forceinline__ uint32_t bit(int within) const {
    if constexpr (W <= 2) {
      return static_cast<uint32_t>(plane64<OFF>() >> within) & 1u;
    } else {
      uint32_t b = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if ((within >> 5) == k) b = (w[OFF + k] >> (within & 31)) & 1u;
      }
      return b;
    }
  }

  // set bits of the plane at OFF among its first `within` positions
  template <int OFF>
  __device__ __forceinline__ uint32_t pop(int within) const {
    if constexpr (W <= 2) {
      return __popcll(plane64<OFF>() & ((1ull << within) - 1ull));
    } else {
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        acc += __popc(w[OFF + k] & rs::low_mask(rs::clamp_bits(within - 32 * k)));
      }
      return acc;
    }
  }

  // occ(c, pos) - checkpoint for the base c = 1 + lo + 2 hi: XNOR-match of
  // the base planes against c's bits, with $ positions (zero base planes)
  // masked out
  __device__ __forceinline__ uint32_t base_pop(uint32_t lo, uint32_t hi,
                                               int within) const {
    if constexpr (W <= 2) {
      const uint64_t t0 = 0ull - lo, t1 = 0ull - hi;
      const uint64_t m = ~(plane64<LO>() ^ t0) & ~(plane64<HI>() ^ t1) &
                         ~plane64<DOLLAR>();
      return __popcll(m & ((1ull << within) - 1ull));
    } else {
      const uint32_t t0 = 0u - lo, t1 = 0u - hi;
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const uint32_t m = ~(w[LO + k] ^ t0) & ~(w[HI + k] ^ t1) & ~w[DOLLAR + k];
        acc += __popc(m & rs::low_mask(rs::clamp_bits(within - 32 * k)));
      }
      return acc;
    }
  }
};

// One row of rank.cuh's layout, held for a walk step.  R4: a 16-byte row
// (row_words == 4, the default) in registers from one vector load.  Else the
// row's address, its words read where they are counted.
template <bool R4>
struct RankRow {
  uint4 v;
  __device__ __forceinline__ void load(const uint32_t* r) {
    v = __ldg(reinterpret_cast<const uint4*>(r));
  }
  // the checkpoint plus the plane's set bits before `within`
  __device__ __forceinline__ int32_t count(int within, int wpb) const {
    return rs::count_row4(v, within, wpb);
  }
  // the plane's bit at `within`
  __device__ __forceinline__ uint32_t bit(int within) const {
    const int k = within >> 5;
    const uint32_t w = k == 0 ? v.y : (k == 1 ? v.z : v.w);
    return (w >> (within & 31)) & 1u;
  }
};

template <>
struct RankRow<false> {
  const uint32_t* r;
  __device__ __forceinline__ void load(const uint32_t* p) { r = p; }
  __device__ __forceinline__ int32_t count(int within, int wpb) const {
    return rs::count_row(r, within, wpb);
  }
  __device__ __forceinline__ uint32_t bit(int within) const {
    return (__ldg(r + 1 + (within >> 5)) >> (within & 31)) & 1u;
  }
};

// ------------------------------------------------------------------ K5

__global__ void resolve_dsa_kernel(const int32_t* __restrict__ l,
                                   const int32_t* __restrict__ u, long long B,
                                   int H, Walk g,
                                   const int32_t* __restrict__ read_to_sample,
                                   long long num_reads,
                                   int32_t* __restrict__ rid_out,
                                   int32_t* __restrict__ off_out,
                                   int32_t* __restrict__ smp_out) {
  const long long total = B * H;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < total; k += stride) {
    const long long q = k / H;
    const int h = static_cast<int>(k - q * H);
    const int32_t lq = __ldg(l + q);
    int32_t rid = -1, off = -1, smp = -1;
    if (h < __ldg(u + q) - lq) {
      dsa_decode(g, lq + h, rid, off);
      if (smp_out != nullptr) {
        smp = __ldg(read_to_sample + clip_index(rid, num_reads));
      }
    }
    rid_out[k] = rid;
    off_out[k] = off;
    if (smp_out != nullptr) smp_out[k] = smp;
  }
}

// ------------------------------------------------- the sweep: walks and K7

// What a sweep gives: the walk kernels (K6, rs_resolve_walk) write (read id,
// offset) for the rows of slots 0..R-1 where valid; K7 counts the worklist
// of the concatenated intervals, up to min(total, cap).
struct Sweep {
  const int32_t* rows;  // the walk kernels
  const uint8_t* valid;
  long long R;
  int32_t* rid_out;
  int32_t* off_out;
  const int32_t* l;  // K7
  const long long* cum;
  long long B;
  long long cap;
  const int32_t* read_to_sample;
  long long num_reads;
  int S;
  int32_t* hist;
};

// A lane's state: the read it issues next.  kRow: the walk's step from its
// row; kRank: the rank row of the symbol just read (two-round steps);
// kMark: a sampled row's mark row (the lf walk's slot rank).
enum State { kIdle = 0, kRow, kPair, kDollar, kSample, kRank, kMark };

// position of the n-th (from 0) set bit of m; n < popc(m)
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// The number of prefix sums cum[0..B) at most x, for a warp-uniform x: the
// first query whose interval passes slot x.  A 128-way search, four
// probes a lane a round, the four loads issued together (two rounds for
// B up to 16,384).
__device__ __forceinline__ long long first_query(const long long* cum,
                                                 long long B, long long x,
                                                 int lane) {
  constexpr long long kNone = 0x7FFFFFFFFFFFFFFFll;
  long long lo = 0, hi = B;  // the answer lies in [lo, hi]
  while (true) {
    const long long step = hi - lo > 128 ? (hi - lo + 127) / 128 : 1;
    long long v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long p = lo + (4 * lane + t + 1) * step - 1;
      v[t] = p < hi ? __ldg(cum + p) : kNone;
    }
    int k = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) k += __popc(__ballot_sync(kFull, v[t] <= x));
    const long long nlo = lo + k * step;
    if (step == 1) return nlo;
    hi = hi < nlo + step - 1 ? hi : nlo + step - 1;
    lo = nlo;
  }
}

// K7's tile of 32 U slots: slot base + 32 u + lane (u < U) → its query
// q[u] and SA row l[q] + (slot - cum[q - 1]).  The prefix sums and
// interval starts of the 32 U queries from the tile's first are staged in
// the warp's shared memory and searched there (more rounds only when the
// tile spans more queries, i.e. empty or one-row intervals).  Slots at or
// past `limit` are left alone.
template <int U>
__device__ __forceinline__ void map_tile(const Sweep& s, long long base,
                                         long long limit, int lane,
                                         long long (&q)[U],
                                         int32_t (&row)[U]) {
  constexpr int Q = 32 * U;
  constexpr long long kNone = 0x7FFFFFFFFFFFFFFFll;
  __shared__ long long staged_cum[kThreads / 32][Q];
  __shared__ int32_t staged_l[kThreads / 32][Q];
  long long* sc = staged_cum[threadIdx.x / 32];
  int32_t* sl = staged_l[threadIdx.x / 32];
  long long qf = first_query(s.cum, s.B, base, lane);
  long long prev0 = qf > 0 ? __ldg(s.cum + qf - 1) : 0;
  bool done[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    done[u] = base + 32 * u + lane >= limit;
    q[u] = 0;
    row[u] = 0;
  }
  while (true) {
    long long c[U];
    int32_t lv[U];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const long long i = qf + 32 * t + lane;
      c[t] = i < s.B ? __ldg(s.cum + i) : kNone;
      lv[t] = i < s.B ? __ldg(s.l + i) : 0;
    }
#pragma unroll
    for (int t = 0; t < U; ++t) {
      sc[32 * t + lane] = c[t];
      sl[32 * t + lane] = lv[t];
    }
    __syncwarp();
    bool all = true;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (done[u]) continue;
      const long long slot = base + 32 * u + lane;
      int j = 0;  // staged sums at most `slot`
#pragma unroll
      for (int k = Q / 2; k > 0; k >>= 1) {
        if (sc[j + k - 1] <= slot) j += k;
      }
      if (j == Q - 1 && sc[Q - 1] <= slot) j = Q;
      if (j < Q) {
        q[u] = qf + j;
        row[u] = sl[j] + static_cast<int32_t>(slot - (j > 0 ? sc[j - 1] : prev0));
        done[u] = true;
      } else {
        all = false;
      }
    }
    if (__all_sync(kFull, all)) return;
    prev0 = sc[Q - 1];
    qf += Q;
    __syncwarp();
  }
}

// K7 through dsa: one read a slot, so no walk to refill.  Warp w takes
// tiles w, w + nwarps, ... of 32 U slots, U a lane, whose dsa and
// read_to_sample reads go out U at a time.
template <int U>
__device__ __forceinline__ void dsa_tiles(const Walk& g, const Sweep& s,
                                          long long limit, long long warp,
                                          long long nwarps, int lane) {
  for (long long base = warp * 32 * U; base < limit;
       base += nwarps * 32 * U) {
    long long q[U];
    int32_t row[U];
    map_tile<U>(s, base, limit, lane, q, row);
    bool in[U];
    uint32_t word[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = base + 32 * u + lane < limit;
      word[u] = in[u] ? __ldg(g.dsa + row[u]) : 0u;
    }
    int32_t smp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t rid = static_cast<int32_t>(word[u] >> g.dsa_bits);
      smp[u] = in[u] ? __ldg(s.read_to_sample + clip_index(rid, s.num_reads))
                     : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long seg = q[u] * s.S + smp[u];
      if (in[u] && seg >= 0 && seg < s.B * s.S) atomicAdd(s.hist + seg, 1);
    }
  }
}

// The walks of the sweep's slots up to `limit`, warp w taking tiles w,
// w + nwarps, ...: walk WALK; HIST: K7 (else a walk kernel).  L: the fused
// walk's words per block; for the rank walks 1 when rows are 16 bytes, 0
// when they are read word by word.  ONE: the marks and slow walks' step in
// one round (else two; see sweep).
template <int WALK, bool HIST, int L, bool ONE>
__device__ __forceinline__ void walk_tiles(const Walk& g, const Sweep& s,
                                           long long limit, long long warp,
                                           long long nwarps, int lane) {
  constexpr bool kTwoRounds = (WALK == kMarks || WALK == kSlow) && !ONE;
  const unsigned lower = (1u << lane) - 1u;
  using Row = FusedRow<WALK == kFused ? L : 1>;
  using RRow = RankRow<L != 0>;
  // C[1..4] in registers (c = 0 ends a walk and needs none)
  const int32_t C1 = __ldg(g.C + 1), C2 = __ldg(g.C + 2),
                C3 = __ldg(g.C + 3), C4 = __ldg(g.C + 4);
  const int lg = g.layout.log2_block;
  const int32_t block_mask = (1 << lg) - 1;
  int st = kIdle;
  int32_t cur = 0;       // kRow, kRank, kMark: the SA row
  int steps = 0;
  int sym = 0;           // kRank: the symbol whose rank row it reads
  long long slot = 0;    // walk kernels: the output slot; K7: the query
  long long tidx = 0;    // kPair, kDollar, kSample: the index read
  unsigned pending = 0;  // claimed slots not started, one per lane
  long long p_slot = 0;
  int32_t p_row = 0;
  long long next = warp * 32;  // the warp's next 32 slots
  bool more = true;

  while (true) {
    // ---- refill: idle lanes take the claimed slots, in order
    unsigned idle = __ballot_sync(kFull, st == kIdle);
    while (idle != 0) {
      if (pending == 0) {
        if (!more) break;
        const long long base = next;
        next += nwarps * 32;
        if (base >= limit) {
          more = false;
          break;
        }
        const long long sl = base + lane;
        const bool in = sl < limit;
        if (!HIST) {
          const uint8_t v = in ? s.valid[sl] : 0;
          p_row = in ? __ldg(s.rows + sl) : 0;
          p_slot = sl;
          if (in && !v) {
            s.rid_out[sl] = -1;
            s.off_out[sl] = -1;
          }
          pending = __ballot_sync(kFull, v != 0);
        } else {
          long long q[1];
          int32_t row[1];
          map_tile<1>(s, base, limit, lane, q, row);
          p_slot = q[0];
          p_row = row[0];
          pending = __ballot_sync(kFull, in);
        }
        continue;
      }
      const int npend = __popc(pending);
      const int r = __popc(idle & lower);
      const int take = __popc(idle) < npend ? __popc(idle) : npend;
      const int src = nth_set(pending, r < take ? r : 0);
      const long long a_slot = __shfl_sync(kFull, p_slot, src);
      const int32_t a_row = __shfl_sync(kFull, p_row, src);
      if (((idle >> lane) & 1u) && r < take) {
        st = kRow;
        cur = a_row;
        steps = 0;
        slot = a_slot;
      }
      pending = take == npend
                    ? 0u
                    : pending & ~((1u << nth_set(pending, take)) - 1u);
      idle = __ballot_sync(kFull, st == kIdle);
    }
    if (!__any_sync(kFull, st != kIdle)) break;

    // ---- the lane's reads, all issued before any is used
    Row row;
    RRow base[4];  // marks, slow: the base planes c = 1..4 at the block
    RRow mrow;     // marks, and lf's kMark: the mark row at the block
    int2 pr = make_int2(0, 0);
    uint32_t word = 0;
    if (st == kRow) {
      const int32_t blk = cur >> lg;
      if constexpr (WALK == kFused) {
        row.load(g.fused + static_cast<size_t>(blk) *
                               static_cast<size_t>(g.fused_words));
      } else if constexpr (WALK == kLf) {
        word = static_cast<uint32_t>(__ldg(g.lf + cur));
      } else {
        if constexpr (ONE) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            base[c].load(rs::row_ptr(g.rank, c + 1, blk, g.layout));
          }
        } else {
          word = __ldg(g.sym4 + (cur >> 3));
        }
        if constexpr (WALK == kMarks) {
          mrow.load(rs::row_ptr(g.marks, 0, blk, g.layout));
        }
      }
    } else if (st == kPair) {
      pr = __ldg(reinterpret_cast<const int2*>(g.pairs) + tidx);
    } else if (st == kDollar) {
      word = static_cast<uint32_t>(__ldg(g.dollar_map + tidx));
    } else if (st == kSample) {
      word = static_cast<uint32_t>(__ldg(s.read_to_sample + tidx));
    } else if (kTwoRounds && st == kRank) {
      base[0].load(rs::row_ptr(g.rank, sym, cur >> lg, g.layout));
    } else if (WALK == kLf && st == kMark) {
      mrow.load(rs::row_ptr(g.marks, 0, cur >> lg, g.layout));
    }

    // ---- what they give.  A walk ends at a marked row (its sampled pair,
    // marked wins) or a $ (occ($, cur) is the $-rank, the dollar_map key),
    // else it steps; a walk still going after max_steps steps gives -1, as
    // the JAX loop's undone lanes do
    int32_t rid = 0, off = 0;
    bool ended = false;
    const int wpb = g.layout.words_per_block;
    if (st == kRow) {
      const int within = cur & block_mask;
      if constexpr (WALK == kFused) {
        if (row.template bit<Row::MARK>(within)) {
          st = kPair;
          tidx = clip_index(static_cast<int32_t>(
                                row.w[5] + row.template pop<Row::MARK>(within)),
                            g.n_pairs);
        } else if (row.template bit<Row::DOLLAR>(within)) {
          st = kDollar;
          tidx = clip_index(static_cast<int32_t>(
                                row.w[0] + row.template pop<Row::DOLLAR>(within)),
                            g.n_dollar);
        } else {
          const uint32_t lo = row.template bit<Row::LO>(within);
          const uint32_t hi = row.template bit<Row::HI>(within);
          const int32_t a1 = C1 + static_cast<int32_t>(row.w[1]);
          const int32_t a2 = C2 + static_cast<int32_t>(row.w[2]);
          const int32_t a3 = C3 + static_cast<int32_t>(row.w[3]);
          const int32_t a4 = C4 + static_cast<int32_t>(row.w[4]);
          cur = (hi ? (lo ? a4 : a3) : (lo ? a2 : a1)) +
                static_cast<int32_t>(row.base_pop(lo, hi, within));
          if (++steps == g.max_steps) {
            rid = -1;
            off = -1;
            ended = true;
          }
        }
      } else if constexpr (WALK == kLf) {
        // sign bit: sampled; an LF value below C[1] is a $ row's $-rank
        const int32_t raw = static_cast<int32_t>(word);
        if (raw < 0) {
          st = kMark;
        } else if (raw < C1) {
          st = kDollar;
          tidx = clip_index(raw, g.n_dollar);
        } else {
          cur = raw;
          if (++steps == g.max_steps) {
            rid = -1;
            off = -1;
            ended = true;
          }
        }
      } else if (WALK == kMarks && mrow.bit(within)) {
        st = kPair;
        tidx = clip_index(mrow.count(within, wpb), g.n_pairs);
      } else if constexpr (kTwoRounds) {
        sym = (word >> ((cur & 7) * 4)) & 0xF;
        st = kRank;
      } else {
        const uint32_t b1 = base[0].bit(within), b2 = base[1].bit(within),
                       b3 = base[2].bit(within);
        if ((b1 | b2 | b3 | base[3].bit(within)) == 0) {
          // $: the five planes partition the BWT, so occ($, cur) is cur
          // less the four base planes' counts
          const int32_t o0 = cur - base[0].count(within, wpb) -
                             base[1].count(within, wpb) -
                             base[2].count(within, wpb) -
                             base[3].count(within, wpb);
          st = kDollar;
          tidx = clip_index(o0, g.n_dollar);
        } else {
          const RRow r = b1 ? base[0] : (b2 ? base[1] : (b3 ? base[2] : base[3]));
          cur = (b1 ? C1 : (b2 ? C2 : (b3 ? C3 : C4))) + r.count(within, wpb);
          if (++steps == g.max_steps) {
            rid = -1;
            off = -1;
            ended = true;
          }
        }
      }
    } else if (st == kPair) {
      rid = pr.x;
      off = pr.y + steps;
      ended = true;
    } else if (st == kDollar) {
      rid = static_cast<int32_t>(word);
      off = steps;
      ended = true;
    } else if (st == kSample) {
      const long long seg = slot * s.S + static_cast<int32_t>(word);
      if (seg >= 0 && seg < s.B * s.S) atomicAdd(s.hist + seg, 1);
      st = kIdle;
    } else if (kTwoRounds && st == kRank) {
      const int32_t o = base[0].count(cur & block_mask, wpb);
      if (sym == 0) {
        st = kDollar;
        tidx = clip_index(o, g.n_dollar);
      } else {
        cur = (sym == 1 ? C1 : (sym == 2 ? C2 : (sym == 3 ? C3 : C4))) + o;
        st = kRow;
        if (++steps == g.max_steps) {
          rid = -1;
          off = -1;
          ended = true;
        }
      }
    } else if (WALK == kLf && st == kMark) {
      st = kPair;
      tidx = clip_index(mrow.count(cur & block_mask, wpb), g.n_pairs);
    }
    if (ended) {
      if (!HIST) {
        s.rid_out[slot] = rid;
        s.off_out[slot] = off;
        st = kIdle;
      } else {
        // an unterminated walk (-1) clips to read 0, as the JAX package does
        st = kSample;
        tidx = clip_index(rid, s.num_reads);
      }
    }
  }
}

// The sweep of walk WALK (see walk_tiles).  The marks and slow walks' step
// is one round of the four base planes' rank rows (one latency) while a
// warp's walks fit its 32 lanes, and two rounds, the sym4 word and then the
// symbol's rank row (3 sectors a step for marks where one round reads 5),
// once walks queue for lanes and the rate of sector reads holds the sweep.
// K7 counts its walks from the limit, a walk kernel from the valid slots of
// the warp's first 4 tiles; each warp then runs the loop of its design.
template <int WALK, bool HIST, int L>
__device__ __forceinline__ void sweep(const Walk& g, const Sweep& s) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  long long limit = s.R;
  if (HIST) {
    const long long total = __ldg(s.cum + s.B - 1);
    limit = s.cap < 0 ? total : (total < s.cap ? total : s.cap);
  }
  if constexpr (WALK == kDsa) {
    // tiles of 32 while no warp has more than one, else of 128
    if (limit <= nwarps * 32) {
      dsa_tiles<1>(g, s, limit, warp, nwarps, lane);
    } else {
      dsa_tiles<4>(g, s, limit, warp, nwarps, lane);
    }
  } else if constexpr (WALK == kMarks || WALK == kSlow) {
    bool one_round;
    if (HIST) {
      one_round = limit <= nwarps * 32;
    } else {
      uint8_t v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long sl = (warp + t * nwarps) * 32 + lane;
        v[t] = sl < limit ? s.valid[sl] : 0;
      }
      int walks = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        walks += __popc(__ballot_sync(kFull, v[t] != 0));
      }
      one_round = walks <= 32;
    }
    if (one_round) {
      walk_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
    } else {
      walk_tiles<WALK, HIST, L, false>(g, s, limit, warp, nwarps, lane);
    }
  } else {
    walk_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resolve_fused_kernel(Walk g, Sweep s) {
  sweep<kFused, false, W>(g, s);
}

template <int WALK, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resolve_walk_kernel(Walk g, Sweep s) {
  sweep<WALK, false, L>(g, s);
}

template <int WALK, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    exact_histogram_kernel(Walk g, Sweep s) {
  sweep<WALK, true, L>(g, s);
}

// ------------------------------------------------------------- rs_chase

__global__ void chase_kernel(const uint32_t* __restrict__ fused,
                             long long n_blocks,
                             const int32_t* __restrict__ start, long long n,
                             int steps, int32_t* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint32_t b = static_cast<uint32_t>(__ldg(start + t));
  for (int k = 0; k < steps; ++k) {
    const uint4* v = reinterpret_cast<const uint4*>(fused + static_cast<size_t>(b) * 16);
    const uint4 x0 = __ldg(v), x1 = __ldg(v + 1), x2 = __ldg(v + 2),
                x3 = __ldg(v + 3);
    uint32_t h = static_cast<uint32_t>(k) ^ x0.x ^ x0.y ^ x0.z ^ x0.w ^ x1.x ^
                 x1.y ^ x1.z ^ x1.w ^ x2.x ^ x2.y ^ x2.z ^ x2.w ^ x3.x ^
                 x3.y ^ x3.z ^ x3.w;
    h *= 0x9E3779B1u;
    b = static_cast<uint32_t>((static_cast<uint64_t>(h) *
                               static_cast<uint64_t>(n_blocks)) >> 32);
  }
  out[t] = static_cast<int32_t>(b);
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

// The persistent grid: as many blocks as the card holds at once, no more
// than `max_blocks`.
template <typename F>
unsigned persistent_grid(F kernel, long long max_blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <typename F>
void launch_sweep(F kernel, const Walk& g, const Sweep& s,
                  long long max_slots, cudaStream_t st) {
  const unsigned grid = persistent_grid(
      kernel, max_slots < 0 ? (1LL << 20) : (max_slots + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, st>>>(g, s);
}

// One sweep kernel: K7 (HIST) or a walk kernel, for the walk and layout.
template <bool HIST, int WALK, int L>
void launch_one(const Walk& g, const Sweep& s, long long max_slots,
                cudaStream_t st) {
  if constexpr (HIST) {
    launch_sweep(exact_histogram_kernel<WALK, L>, g, s, max_slots, st);
  } else if constexpr (WALK == kFused) {
    launch_sweep(resolve_fused_kernel<L>, g, s, max_slots, st);
  } else {
    launch_sweep(resolve_walk_kernel<WALK, L>, g, s, max_slots, st);
  }
}

// The rank walks' instantiation for the table's row width.
template <bool HIST, int WALK>
void launch_rank(const Walk& g, const Sweep& s, long long max_slots,
                 cudaStream_t st) {
  if (g.layout.row_words == 4) {
    launch_one<HIST, WALK, 1>(g, s, max_slots, st);
  } else {
    launch_one<HIST, WALK, 0>(g, s, max_slots, st);
  }
}

template <int W>
bool fused_layout_ok(int fused_words) {
  return fused_words == FusedRow<W>::R;
}

// Whether `kind` can walk these tables, the sweep's caller HIST or not.
bool walk_ok(int kind, bool hist, const Walk& g) {
  const rs::Layout& y = g.layout;
  switch (kind) {
    case kDsa:
      return hist && g.dsa_bits >= 1 && g.dsa_bits <= 31;
    case kFused:
      switch (y.words_per_block) {
        case 1: return fused_layout_ok<1>(g.fused_words);
        case 2: return fused_layout_ok<2>(g.fused_words);
        case 4: return fused_layout_ok<4>(g.fused_words);
        case 8: return fused_layout_ok<8>(g.fused_words);
        default: return false;
      }
    case kMarks:
    case kLf:
    case kSlow:
      return y.words_per_block >= 1 && y.row_words >= y.words_per_block + 1 &&
             (y.words_per_block << 5) == (1 << y.log2_block);
    default:
      return false;
  }
}

template <bool HIST>
void launch(int kind, const Walk& g, const Sweep& s, long long max_slots,
            cudaStream_t st) {
  switch (kind) {
    case kDsa:
      if constexpr (HIST) launch_one<true, kDsa, 1>(g, s, max_slots, st);
      break;
    case kFused:
      switch (g.layout.words_per_block) {
        case 1: launch_one<HIST, kFused, 1>(g, s, max_slots, st); break;
        case 2: launch_one<HIST, kFused, 2>(g, s, max_slots, st); break;
        case 4: launch_one<HIST, kFused, 4>(g, s, max_slots, st); break;
        case 8: launch_one<HIST, kFused, 8>(g, s, max_slots, st); break;
      }
      break;
    case kMarks: launch_rank<HIST, kMarks>(g, s, max_slots, st); break;
    case kLf: launch_rank<HIST, kLf>(g, s, max_slots, st); break;
    case kSlow: launch_rank<HIST, kSlow>(g, s, max_slots, st); break;
  }
}

}  // namespace

// The walk's tables, in the order every sweep entry point takes them (see
// Walk); a kind's unused tables may be null.
#define RS_WALK_PARAMS                                                       \
  const void *dsa, int dsa_bits, const void *fused, int fused_words,         \
      const void *rank, const void *sym4, const void *marks, const void *lf, \
      long long rows_per_symbol, int log2_block, int words_per_block,        \
      int row_words, const void *C, const void *dollar_map,                  \
      long long n_dollar, const void *pairs, long long n_pairs, int max_steps
#define RS_WALK_OF_PARAMS                                                    \
  Walk {                                                                     \
    static_cast<const uint32_t*>(dsa), dsa_bits,                             \
        static_cast<const uint32_t*>(fused), fused_words,                    \
        static_cast<const uint32_t*>(rank),                                  \
        static_cast<const uint32_t*>(sym4),                                  \
        static_cast<const uint32_t*>(marks),                                 \
        static_cast<const int32_t*>(lf),                                     \
        rs::Layout{rows_per_symbol, log2_block, words_per_block, row_words}, \
        static_cast<const int32_t*>(C),                                      \
        static_cast<const int32_t*>(dollar_map), n_dollar,                   \
        static_cast<const int32_t*>(pairs), n_pairs, max_steps               \
  }

extern "C" int rs_resolve_dsa(const void* l, const void* u, long long B,
                              int H, const void* dsa, int dsa_bits,
                              const void* read_to_sample, long long num_reads,
                              void* rid, void* off, void* smp, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dsa_bits < 1 || dsa_bits > 31) return cudaErrorInvalidValue;
  Walk g{};
  g.dsa = static_cast<const uint32_t*>(dsa);
  g.dsa_bits = dsa_bits;
  const int threads = 256;
  resolve_dsa_kernel<<<grid_for(B * H, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(u), B, H, g,
      static_cast<const int32_t*>(read_to_sample), num_reads,
      static_cast<int32_t*>(rid), static_cast<int32_t*>(off),
      static_cast<int32_t*>(smp));
  return static_cast<int>(cudaGetLastError());
}

// K6 (kind fused) and the rank walks (marks, lf, slow): rows [R] where
// valid → (read id, offset), -1 where invalid or unterminated.
static int resolve_rows(int kind, const void* rows, const void* valid,
                        long long R, const Walk& g, void* rid, void* off,
                        void* stream) {
  if (R <= 0) return 0;
  if (kind == kDsa || !walk_ok(kind, false, g) || g.max_steps < 1) {
    return cudaErrorInvalidValue;
  }
  Sweep s{};
  s.rows = static_cast<const int32_t*>(rows);
  s.valid = static_cast<const uint8_t*>(valid);
  s.R = R;
  s.rid_out = static_cast<int32_t*>(rid);
  s.off_out = static_cast<int32_t*>(off);
  launch<false>(kind, g, s, R, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_resolve_fused(const void* rows, const void* valid,
                                long long R, RS_WALK_PARAMS, void* rid,
                                void* off, void* stream) {
  return resolve_rows(kFused, rows, valid, R, RS_WALK_OF_PARAMS, rid, off,
                      stream);
}

extern "C" int rs_resolve_walk(int kind, const void* rows, const void* valid,
                               long long R, RS_WALK_PARAMS, void* rid,
                               void* off, void* stream) {
  if (kind != kMarks && kind != kLf && kind != kSlow) {
    return cudaErrorInvalidValue;
  }
  return resolve_rows(kind, rows, valid, R, RS_WALK_OF_PARAMS, rid, off,
                      stream);
}

extern "C" int rs_exact_histogram(const void* l, const void* cum, long long B,
                                  long long cap, int kind, RS_WALK_PARAMS,
                                  const void* read_to_sample,
                                  long long num_reads, int S, void* hist,
                                  void* stream) {
  if (B <= 0 || cap == 0) return 0;
  const Walk g = RS_WALK_OF_PARAMS;
  if (!walk_ok(kind, true, g) || (kind != kDsa && g.max_steps < 1)) {
    return cudaErrorInvalidValue;
  }
  Sweep s{};
  s.l = static_cast<const int32_t*>(l);
  s.cum = static_cast<const long long*>(cum);
  s.B = B;
  s.cap = cap;
  s.read_to_sample = static_cast<const int32_t*>(read_to_sample);
  s.num_reads = num_reads;
  s.S = S;
  s.hist = static_cast<int32_t*>(hist);
  launch<true>(kind, g, s, cap, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_chase(const void* fused, int fused_words, long long n_blocks,
                        const void* start, long long n, int steps, void* out,
                        void* stream) {
  if (n <= 0) return 0;
  if (fused_words != 16 || n_blocks <= 0 || steps < 0) {
    return cudaErrorInvalidValue;
  }
  const int threads = 128;
  chase_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fused), n_blocks,
      static_cast<const int32_t*>(start), n, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
