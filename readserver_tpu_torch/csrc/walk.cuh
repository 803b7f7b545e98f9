// The walks and the exact sweep, one persistent sweep of lanes over slots,
// shared by the single-index kernels (resolve.cu: K6, K7, and through
// rank_tiles below the marks, lf and slow walks and K7 through them) and
// the interval-sharded K10 (sharded.cu).  walk_tiles serves K6 and K10,
// which differ only in their table accessor (below): where a row's tables
// lie and what a local count adds up to.
//
// What bounds them on the H100: chains of up to sample_rate (slow walk:
// max_steps) dependent row reads and one terminal read, over tens to
// hundreds of thousands of walks that share rows: the chain (one read's
// latency, ~0.25 us from L2, times the reads a walk makes) and the
// instructions each step issues, until the walks outnumber the lanes the
// card holds at once and the rate of sector reads holds them.  The sweep
// through dsa is a short chain per slot (its query, its dsa word, its
// sample) and, at a full worklist, the rate of those reads.
//
// What the design does about it:
// - A persistent grid (occupancy x SMs).  Warp w takes tiles w,
//   w + nwarps, ... of consecutive slots, so one query's neighbouring rows
//   stay in one warp and share sectors.  No counter: claiming through one
//   atomicAdd measured slower, its queue standing in the walks' way.
// - The walks: tiles of 32, and lane refill: a lane whose walk ended takes
//   its warp's next slot, so lanes stay busy when the walks outnumber
//   resident threads.  walk_tiles: each iteration a lane issues the reads
//   of its state before any lane uses one: a walk's terminal read (its
//   sampled pair or $-map entry) and the read_to_sample read are lane
//   states of their own, issued beside the other lanes' row reads rather
//   than after them.  rank_tiles adds a hot loop of the step alone (see
//   there).  C in registers.
// - The fused walk: one 64-byte row a step, W <= 2's bit planes as 64-bit
//   words, so a row's decode is a few shifts, masks and popcounts.
// - The marks and slow walks: while a warp's walks fit its lanes, one
//   round of independent 16-byte reads a step, the four base planes' rank
//   rows at the row's block (and for marks the mark row).  The five planes
//   partition the BWT (and each shard's slice of it), so the symbol is the
//   base plane whose bit is set, or $ when none is, and occ($, i) = i less
//   the four base counts: a step is one latency where the symbol read and
//   the rank read of its plane would be two.  Once walks queue for lanes
//   the sweep is held by the rate of sector reads, and a step takes those
//   two rounds, the sym4 word (and mark row), then the symbol's rank row:
//   3 sectors where one round reads 5.  The switch is at Sweep::one_max
//   walks a warp.  Ranks count with rank.cuh's code.
// - The lf walk: one 4-byte LF word a step; a sampled row's slot is its
//   mark row's rank, read as a state of its own.
// - The sweep maps a tile's slots to (query, row) once: a 128-way search
//   of the int64 prefix sums for the tile's first query, then the sums and
//   interval starts the tile spans, staged in the warp's shared memory and
//   searched there.  Through dsa, a tile is 128 slots, four a lane, whose
//   dsa and read_to_sample reads go out four at a time.  The sweep's limit,
//   min(total, cap), is read on the card, so no launch waits for the host.
//
// The table accessor G, a struct the kernel builds and hands down:
//   Pos                  a global SA row: int32_t, or long long for an
//                        index of 2^31 rows or more;
//   from_input(row)      an input row (the sweep's In type, which may be
//                        wider) as a Pos, rows outside the index kept so;
//   Loc, at(row)         a row located in its table: one index {row}; the
//                        sharded index {owner shard, local int32 row};
//   kSample              the walk kernels write each lane's sample too;
//   inside(row)          whether a row lies in the index (a slow walk's
//                        first row outside it ends as a $ row at once,
//                        with the $-rank outside_drank(row));
//   local(loc)           the row within its table (its block and bit);
//   rank_row(loc, c), mark_row(loc), lf_word(loc), sym4_word(loc)
//                        the rank row of plane c at the row's block, the
//                        mark row, the LF word, the sym4 word;
//   rank_of(loc, c, n)   the global rank from the local count n;
//   mark_slot(loc, n)    the sampled pair's slot from the local mark rank;
//   pair(slot), dollar(drank), sample(read id), dsa_word(row)
//                        the terminal lookups (their own key rules: a clip,
//                        or 0 where no shard owns the key);
//   C_at(c), dollar_limit()
//                        C, and the LF values that are $ rows' $-ranks;
//   layout, dsa_bits, max_steps, and for the fused walk fused, fused_words.
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace rs {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSweepThreads = 128;  // persistent blocks of 4 warps
// The marks and slow walks step in one round while a warp holds at most
// this many walks, else in two: the crossover measured on the H100 at the
// served shape (PERF.md §6).
constexpr int kOneRoundMax = 32;

// The walk kinds, numbered as the entry points take them.
enum WalkKind { kDsa = 0, kFused = 1, kMarks = 2, kLf = 3, kSlow = 4 };

__device__ __forceinline__ long long clip_index(long long i, long long n) {
  const long long hi = n > 0 ? n - 1 : 0;
  return i < 0 ? 0 : (i > hi ? hi : i);
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
        acc += __popc(w[OFF + k] & low_mask(clamp_bits(within - 32 * k)));
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
        acc += __popc(m & low_mask(clamp_bits(within - 32 * k)));
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
    return count_row4(v, within, wpb);
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
    return count_row(r, within, wpb);
  }
  __device__ __forceinline__ uint32_t bit(int within) const {
    return (__ldg(r + 1 + (within >> 5)) >> (within & 31)) & 1u;
  }
};

// What a sweep gives: the walk kernels write (read id, offset), and where
// the accessor's kSample the sample of clip(read id), for the rows of slots
// 0..R-1 where valid; the exact sweep (HIST) counts the worklist of the
// concatenated intervals, up to min(total, cap), into hist [B, S].
template <class Pos>
struct Sweep {
  const Pos* rows;  // the walk kernels
  const uint8_t* valid;
  long long R;
  int32_t* rid_out;
  int32_t* off_out;
  int32_t* smp_out;
  const Pos* l;  // the exact sweep
  const long long* cum;
  long long B;
  long long cap;
  int S;
  int32_t* hist;
  int one_max = kOneRoundMax;  // marks, slow: see one_round
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

// The sweep's tile of 32 U slots: slot base + 32 u + lane (u < U) → its
// query q[u] and SA row l[q] + (slot - cum[q - 1]).  The prefix sums and
// interval starts of the 32 U queries from the tile's first are staged in
// the warp's shared memory and searched there (more rounds only when the
// tile spans more queries, i.e. empty or one-row intervals).  Slots at or
// past `limit` are left alone.
template <int U, class In>
__device__ __forceinline__ void map_tile(const Sweep<In>& s, long long base,
                                         long long limit, int lane,
                                         long long (&q)[U], In (&row)[U]) {
  constexpr int Q = 32 * U;
  constexpr long long kNone = 0x7FFFFFFFFFFFFFFFll;
  __shared__ long long staged_cum[kSweepThreads / 32][Q];
  __shared__ In staged_l[kSweepThreads / 32][Q];
  long long* sc = staged_cum[threadIdx.x / 32];
  In* sl = staged_l[threadIdx.x / 32];
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
    In lv[U];
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
        row[u] = sl[j] + static_cast<In>(slot - (j > 0 ? sc[j - 1] : prev0));
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

// The sweep through dsa: one read a slot, so no walk to refill.  Warp w
// takes tiles w, w + nwarps, ... of 32 U slots, U a lane, whose dsa and
// read_to_sample reads go out U at a time.
template <int U, class G, class In>
__device__ __forceinline__ void dsa_tiles(const G& g, const Sweep<In>& s,
                                          long long limit, long long warp,
                                          long long nwarps, int lane) {
  for (long long base = warp * 32 * U; base < limit;
       base += nwarps * 32 * U) {
    long long q[U];
    In row[U];
    map_tile<U>(s, base, limit, lane, q, row);
    bool in[U];
    uint32_t word[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = base + 32 * u + lane < limit;
      word[u] = in[u] ? g.dsa_word(g.from_input(row[u])) : 0u;
    }
    int32_t smp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t rid = static_cast<int32_t>(word[u] >> g.dsa_bits);
      smp[u] = in[u] ? g.sample(rid) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long seg = q[u] * s.S + smp[u];
      if (in[u] && seg >= 0 && seg < s.B * s.S) atomicAdd(s.hist + seg, 1);
    }
  }
}

// The walks of the sweep's slots up to `limit`, warp w taking tiles w,
// w + nwarps, ...: walk WALK; HIST: the exact sweep (else a walk kernel).
// L: the fused walk's words per block; for the rank walks 1 when rows are
// 16 bytes, 0 when they are read word by word.  ONE: the marks and slow
// walks' step in one round (else two; see sweep).
template <int WALK, bool HIST, int L, bool ONE, class G, class In>
__device__ __forceinline__ void walk_tiles(const G& g, const Sweep<In>& s,
                                           long long limit, long long warp,
                                           long long nwarps, int lane) {
  using Pos = typename G::Pos;
  using Loc = typename G::Loc;
  constexpr bool kTwoRounds = WALK == kSlow && !ONE;
  constexpr bool kSmp = !HIST && G::kSample;
  const unsigned lower = (1u << lane) - 1u;
  using Row = FusedRow<WALK == kFused ? L : 1>;
  using RRow = RankRow<L != 0>;
  // C[1..4] in registers (c = 0 ends a walk and needs none)
  const Pos C1 = g.C_at(1), C2 = g.C_at(2), C3 = g.C_at(3), C4 = g.C_at(4);
  const Pos below = g.dollar_limit();  // lf: LF values that are $-ranks
  const int lg = g.layout.log2_block;
  const int32_t block_mask = (1 << lg) - 1;
  // the sample of an invalid lane: read id -1 clips to read 0
  const int32_t smp0 = kSmp ? g.sample(-1) : 0;
  int st = kIdle;
  Pos cur = 0;           // kRow, kRank, kMark: the SA row
  int steps = 0;
  int sym = 0;           // kRank: the symbol whose rank row it reads
  long long slot = 0;    // walk kernels: the output slot; sweep: the query
  long long tidx = 0;    // kPair, kDollar, kSample: the key looked up
  unsigned pending = 0;  // claimed slots not started, one per lane
  long long p_slot = 0;
  Pos p_row = 0;
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
          p_row = g.from_input(in ? __ldg(s.rows + sl) : In(0));
          p_slot = sl;
          if (in && !v) {
            s.rid_out[sl] = -1;
            s.off_out[sl] = -1;
            if constexpr (kSmp) s.smp_out[sl] = smp0;
          }
          pending = __ballot_sync(kFull, v != 0);
        } else {
          long long q[1];
          In row[1];
          map_tile<1>(s, base, limit, lane, q, row);
          p_slot = q[0];
          p_row = g.from_input(row[0]);
          pending = __ballot_sync(kFull, in);
        }
        continue;
      }
      const int npend = __popc(pending);
      const int r = __popc(idle & lower);
      const int take = __popc(idle) < npend ? __popc(idle) : npend;
      const int src = nth_set(pending, r < take ? r : 0);
      const long long a_slot = __shfl_sync(kFull, p_slot, src);
      const Pos a_row = __shfl_sync(kFull, p_row, src);
      if (((idle >> lane) & 1u) && r < take) {
        st = kRow;
        cur = a_row;
        steps = 0;
        slot = a_slot;
        if constexpr (WALK == kSlow) {
          if (!g.inside(cur)) {  // no rows to read: a $ row at once
            st = kDollar;
            tidx = g.outside_drank(cur);
          }
        }
      }
      pending = take == npend
                    ? 0u
                    : pending & ~((1u << nth_set(pending, take)) - 1u);
      idle = __ballot_sync(kFull, st == kIdle);
    }
    if (!__any_sync(kFull, st != kIdle)) break;

    // ---- the lane's reads, all issued before any is used
    Loc at{};
    if constexpr (WALK != kFused) {
      if (st == kRow || (kTwoRounds && st == kRank) ||
          (WALK == kLf && st == kMark)) {
        at = g.at(cur);
      }
    }
    Row row;
    RRow base[4];  // slow: the base planes c = 1..4 at the block
    RRow mrow;     // lf's kMark: the mark row at the block
    int2 pr = make_int2(0, 0);
    uint32_t word = 0;
    if (st == kRow) {
      if constexpr (WALK == kFused) {
        const int32_t blk = cur >> lg;
        row.load(g.fused + static_cast<size_t>(blk) *
                               static_cast<size_t>(g.fused_words));
      } else if constexpr (WALK == kLf) {
        word = static_cast<uint32_t>(g.lf_word(at));
      } else {
        if constexpr (ONE) {
#pragma unroll
          for (int c = 0; c < 4; ++c) base[c].load(g.rank_row(at, c + 1));
        } else {
          word = g.sym4_word(at);
        }
      }
    } else if (st == kPair) {
      pr = g.pair(tidx);
    } else if (st == kDollar) {
      word = static_cast<uint32_t>(g.dollar(tidx));
    } else if (st == kSample) {
      word = static_cast<uint32_t>(g.sample(tidx));
    } else if (kTwoRounds && st == kRank) {
      base[0].load(g.rank_row(at, sym));
    } else if (WALK == kLf && st == kMark) {
      mrow.load(g.mark_row(at));
    }

    // ---- what they give.  A walk ends at a marked row (its sampled pair,
    // marked wins) or a $ (occ($, cur) is the $-rank, the $-map key), else
    // it steps; a walk still going after max_steps steps gives -1, as the
    // JAX loop's undone lanes do
    int32_t rid = 0, off = 0;
    bool ended = false;
    const int wpb = g.layout.words_per_block;
    if (st == kRow) {
      if constexpr (WALK == kFused) {
        const int within = cur & block_mask;
        if (row.template bit<Row::MARK>(within)) {
          st = kPair;
          tidx = static_cast<int32_t>(row.w[5] + row.template pop<Row::MARK>(within));
        } else if (row.template bit<Row::DOLLAR>(within)) {
          st = kDollar;
          tidx = static_cast<int32_t>(row.w[0] + row.template pop<Row::DOLLAR>(within));
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
        // sign bit: sampled; an LF value below `below` is a $ row's $-rank
        const int32_t raw = static_cast<int32_t>(word);
        if (raw < 0) {
          st = kMark;
        } else if (raw < below) {
          st = kDollar;
          tidx = raw;
        } else {
          cur = raw;
          if (++steps == g.max_steps) {
            rid = -1;
            off = -1;
            ended = true;
          }
        }
      } else {
        const int within = g.local(at) & block_mask;
        if constexpr (kTwoRounds) {
          sym = (word >> ((g.local(at) & 7) * 4)) & 0xF;
          st = kRank;
        } else {
          const uint32_t b1 = base[0].bit(within), b2 = base[1].bit(within),
                         b3 = base[2].bit(within);
          if ((b1 | b2 | b3 | base[3].bit(within)) == 0) {
            // $: the five planes partition the BWT, so occ($, cur) is cur
            // less the four base planes' counts
            const int32_t o0 = g.local(at) - base[0].count(within, wpb) -
                               base[1].count(within, wpb) -
                               base[2].count(within, wpb) -
                               base[3].count(within, wpb);
            st = kDollar;
            tidx = g.rank_of(at, 0, o0);
          } else {
            const int c = b1 ? 1 : (b2 ? 2 : (b3 ? 3 : 4));
            const RRow r = b1 ? base[0] : (b2 ? base[1] : (b3 ? base[2] : base[3]));
            cur = (b1 ? C1 : (b2 ? C2 : (b3 ? C3 : C4))) +
                  g.rank_of(at, c, r.count(within, wpb));
            if (++steps == g.max_steps) {
              rid = -1;
              off = -1;
              ended = true;
            }
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
      if constexpr (HIST) {
        const long long seg = slot * s.S + static_cast<int32_t>(word);
        if (seg >= 0 && seg < s.B * s.S) atomicAdd(s.hist + seg, 1);
      } else if constexpr (kSmp) {
        s.smp_out[slot] = static_cast<int32_t>(word);
      }
      st = kIdle;
    } else if (kTwoRounds && st == kRank) {
      const Pos o = g.rank_of(at, sym, base[0].count(g.local(at) & block_mask, wpb));
      if (sym == 0) {
        st = kDollar;
        tidx = o;
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
      tidx = g.mark_slot(at, mrow.count(g.local(at) & block_mask, wpb));
    }
    if (ended) {
      if (!HIST) {
        s.rid_out[slot] = rid;
        s.off_out[slot] = off;
      }
      if constexpr (HIST || kSmp) {
        // the sample of clip(read id): an unterminated walk (-1) clips to
        // read 0, as the JAX package does
        st = kSample;
        tidx = rid;
      } else {
        st = kIdle;
      }
    }
  }
}

// ------------------------------------------ the single-index rank walks
//
// The marks, lf and slow walks over one index (resolve.cu's Walk), and K7
// through them: rank_tiles, not walk_tiles, which K10 keeps.  G must give
// the table pointers rank, marks, sym4, lf and pairs, dollar_map,
// n_pairs, n_dollar, and plane_words, the words between two planes of the
// rank table (its word offsets fit 32 bits: the entry point checks).
// What the step does differently (PERF.md §6 has the measurements):
// - A hot loop of the step alone: the stepping lanes step with no state
//   dispatch, no refill and one ballot a step.  While the warp has slots
//   left to take, it runs only while every lane steps; once the slots are
//   taken, while any lane does, so the ended walks wait and their
//   terminal reads (a sampled pair or a $-map entry; the lf walk's mark
//   row first; K7's read_to_sample after) go out together.
// - Around it, the general iteration: idle lanes take slots, and the
//   waiting lanes' terminal reads are issued before the stepping lanes'
//   row reads, so the two overlap.  Two ballots (the stepping and the
//   waiting lanes) stand for the six-way state dispatch.
// - The marks and slow walks' one-round step holds each plane's row as
//   its checkpoint and one 64-bit word (16-byte rows: blocks of 32 or 64
//   symbols), selects the symbol's checkpoint, word and C, and counts
//   that plane only; the four planes are counted only at a $.  Row
//   offsets are 32-bit words from each table's base.

// One plane's row at a block, held for a step.  R4: a 16-byte row
// [checkpoint, w0, w1, pad] as the checkpoint and w1:w0 (for blocks of
// 32, w1 is padding that no position below 32 reads); else the row's
// address, read word by word (RankRow<false>).
template <bool R4>
struct PlaneRow : RankRow<false> {};

template <>
struct PlaneRow<true> {
  uint32_t ck;
  uint64_t bits;
  __device__ __forceinline__ void load(const uint32_t* r) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(r));
    ck = v.x;
    bits = (static_cast<uint64_t>(v.z) << 32) | v.y;
  }
  __device__ __forceinline__ uint32_t bit(int within) const {
    return static_cast<uint32_t>(bits >> within) & 1u;
  }
  __device__ __forceinline__ int32_t count(int within, int) const {
    return static_cast<int32_t>(ck + __popcll(bits & ((1ull << within) - 1ull)));
  }
};

// The slots up to `limit` through walk WALK (kMarks, kLf, kSlow), warp w
// taking tiles w, w + nwarps, ...; HIST: K7's sweep; L: 16-byte rows (1)
// or any (0); ONE: the marks and slow walks' step in one round, else two
// (the sym4 word and mark row, then the symbol's rank row).
template <int WALK, bool HIST, int L, bool ONE, class G, class In>
__device__ __forceinline__ void rank_tiles(const G& g, const Sweep<In>& s,
                                           long long limit, long long warp,
                                           long long nwarps, int lane) {
  using Row = PlaneRow<L != 0>;
  const unsigned lower = (1u << lane) - 1u;
  const int32_t C1 = g.C_at(1), C2 = g.C_at(2), C3 = g.C_at(3), C4 = g.C_at(4);
  const int32_t below = g.dollar_limit();  // lf: LF values that are $-ranks
  const int lg = g.layout.log2_block;
  const int32_t bmask = (1 << lg) - 1;
  const int wpb = g.layout.words_per_block;
  const uint32_t rw = L != 0 ? 4u : static_cast<uint32_t>(g.layout.row_words);
  const uint32_t pw = static_cast<uint32_t>(g.plane_words);
  int st = kIdle;
  int32_t cur = 0;       // kRow, kMark: the SA row
  int steps = 0;
  int32_t key = 0;       // kPair, kDollar, kSample: the key looked up
  long long slot = 0;    // walk kernels: the output slot; K7: the query
  unsigned pending = 0;  // claimed slots not started, one per lane
  long long p_slot = 0;
  int32_t p_row = 0;
  long long next = warp * 32;  // the warp's next 32 slots
  bool more = true;

  // a walk still going after max_steps steps gives -1 (K7: read 0's
  // sample, as clip(-1) does)
  auto unended = [&]() {
    if constexpr (HIST) {
      st = kSample;
      key = -1;
    } else {
      s.rid_out[slot] = -1;
      s.off_out[slot] = -1;
      st = kIdle;
    }
  };
  // one step of a kRow lane: its next row, or the walk's end (kPair,
  // kDollar; the lf walk's kMark)
  auto step = [&]() {
    const int within = cur & bmask;
    const uint32_t off = static_cast<uint32_t>(cur >> lg) * rw;
    if constexpr (WALK == kLf) {
      // sign bit: sampled; an LF value below `below` is a $ row's $-rank
      const int32_t raw = __ldg(g.lf + cur);
      if (raw < 0) {
        st = kMark;
      } else if (raw < below) {
        st = kDollar;
        key = raw;
      } else {
        cur = raw;
        if (++steps == g.max_steps) unended();
      }
    } else if constexpr (ONE) {
      Row r1, r2, r3, r4, m;
      r1.load(g.rank + (pw + off));
      r2.load(g.rank + (2u * pw + off));
      r3.load(g.rank + (3u * pw + off));
      r4.load(g.rank + (4u * pw + off));
      if constexpr (WALK == kMarks) m.load(g.marks + off);
      if (WALK == kMarks && m.bit(within)) {
        st = kPair;
        key = m.count(within, wpb);
        return;
      }
      const uint32_t x1 = r1.bit(within), x2 = r2.bit(within),
                     x3 = r3.bit(within);
      if ((x1 | x2 | x3 | r4.bit(within)) == 0) {
        // $: the five planes partition the BWT, so occ($, cur) is cur
        // less the four base planes' counts
        st = kDollar;
        key = cur - r1.count(within, wpb) - r2.count(within, wpb) -
              r3.count(within, wpb) - r4.count(within, wpb);
        return;
      }
      const Row r = x1 ? r1 : (x2 ? r2 : (x3 ? r3 : r4));
      cur = (x1 ? C1 : (x2 ? C2 : (x3 ? C3 : C4))) + r.count(within, wpb);
      if (++steps == g.max_steps) unended();
    } else {
      const uint32_t w = __ldg(g.sym4 + (cur >> 3));
      Row m;
      if constexpr (WALK == kMarks) m.load(g.marks + off);
      if (WALK == kMarks && m.bit(within)) {
        st = kPair;
        key = m.count(within, wpb);
        return;
      }
      const int sym = (w >> ((cur & 7) * 4)) & 0xF;
      Row r;
      r.load(g.rank + (static_cast<uint32_t>(sym) * pw + off));
      const int32_t o = r.count(within, wpb);
      if (sym == 0) {
        st = kDollar;
        key = o;
        return;
      }
      cur = (sym == 1 ? C1 : (sym == 2 ? C2 : (sym == 3 ? C3 : C4))) + o;
      if (++steps == g.max_steps) unended();
    }
  };

  // K7 through the lf walk takes no hot loop: its one-read steps end often
  // while the worklist lasts, and the loop's shape cost it 5-6% on the
  // card (PERF.md §6)
  constexpr bool kHot = !(HIST && WALK == kLf);
  // the lanes stepping and the lanes waiting on a terminal read, by two
  // ballots (the rest are idle)
  unsigned row = 0, wait = 0;
  while (true) {
    if constexpr (!kHot) {
      row = __ballot_sync(kFull, st == kRow);
      wait = __ballot_sync(kFull, st > kRow);
    }
    const bool fill = pending != 0 || more;
    // ---- refill, only when some lane is idle and slots are left
    if ((row | wait) != kFull && fill) {
      unsigned idle = ~(row | wait);
      const unsigned was = idle;
      while (idle != 0 && (pending != 0 || more)) {
        if (pending == 0) {
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
            In first[1];
            map_tile<1>(s, base, limit, lane, q, first);
            p_slot = q[0];
            p_row = static_cast<int32_t>(first[0]);
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
        const bool mine = ((idle >> lane) & 1u) && r < take;
        if (mine) {
          st = kRow;
          cur = a_row;
          steps = 0;
          slot = a_slot;
        }
        pending = take == npend
                      ? 0u
                      : pending & ~((1u << nth_set(pending, take)) - 1u);
        idle &= ~__ballot_sync(kFull, mine);
      }
      row |= was & ~idle;  // the lanes just started
    }
    if ((row | wait) == 0) break;

    // ---- the general iteration: the waiting lanes' terminal reads, issued
    // before the stepping lanes' row reads and used after them (without
    // the hot loop, once the slots are taken, only when no lane steps)
    const bool term = wait != 0 && (kHot || fill || row == 0);
    const int st0 = st;
    int32_t v0 = 0, v1 = 0;
    Row mk;
    if (term) {
      if (st0 == kPair) {
        const int2 pr = g.pair(key);
        v0 = pr.x;
        v1 = pr.y;
      } else if (st0 == kDollar) {
        v0 = g.dollar(key);
      } else if (HIST && st0 == kSample) {
        v0 = g.sample(key);
      } else if (WALK == kLf && st0 == kMark) {
        mk.load(g.marks + static_cast<uint32_t>(cur >> lg) * rw);
      }
    }
    if (st0 == kRow) step();
    if (term) {
      if (st0 == kPair || st0 == kDollar) {
        if constexpr (HIST) {
          st = kSample;
          key = v0;
        } else {
          s.rid_out[slot] = v0;
          s.off_out[slot] = v1 + steps;
          st = kIdle;
        }
      } else if (HIST && st0 == kSample) {
        const long long seg = slot * s.S + v0;
        if (seg >= 0 && seg < s.B * s.S) atomicAdd(s.hist + seg, 1);
        st = kIdle;
      } else if (WALK == kLf && st0 == kMark) {
        st = kPair;
        key = mk.count(cur & bmask, wpb);
      }
    }

    // ---- the hot loop, the step alone: while slots are left, only while
    // every lane steps; once they are all taken, while any lane does, the
    // waiting lanes waiting, so their terminal reads go out together
    if constexpr (kHot) {
      const bool left = pending != 0 || more;
      while (true) {
        row = __ballot_sync(kFull, st == kRow);
        if (row == 0 || (left && row != kFull)) break;
        if (st == kRow) step();
      }
      wait = __ballot_sync(kFull, st > kRow);
    }
  }
}

// Whether the marks and slow walks' step takes one round: while a warp's
// walks fit s.one_max.  The exact sweep counts its walks from the limit, a
// walk kernel from the valid slots of the warp's first 4 tiles.
template <bool HIST, class In>
__device__ __forceinline__ bool one_round(const Sweep<In>& s, long long limit,
                                          long long warp, long long nwarps,
                                          int lane) {
  if (HIST) return limit <= nwarps * s.one_max;
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
  return walks <= s.one_max;
}

// The sweep of walk WALK (see walk_tiles; over one index, whose accessor's
// kRankTiles is set, the marks, lf and slow walks run rank_tiles).  The
// marks and slow walks' step
// is one round of the four base planes' rank rows (one latency) while a
// warp's walks fit its 32 lanes, and two rounds, the sym4 word and then the
// symbol's rank row (3 sectors a step for marks where one round reads 5),
// once walks queue for lanes and the rate of sector reads holds the sweep.
// The exact sweep counts its walks from the limit, a walk kernel from the
// valid slots of the warp's first 4 tiles; each warp then runs the loop of
// its design.
template <int WALK, bool HIST, int L, class G, class In>
__device__ __forceinline__ void sweep(const G& g, const Sweep<In>& s) {
  const int lane = threadIdx.x & 31;
  const long long nwarps =
      static_cast<long long>(gridDim.x) * (kSweepThreads / 32);
  const long long warp = static_cast<long long>(blockIdx.x) *
                             (kSweepThreads / 32) + threadIdx.x / 32;
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
  } else if constexpr (G::kRankTiles && WALK == kLf) {
    rank_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
  } else if constexpr (G::kRankTiles && WALK != kFused) {  // marks, slow
    if (one_round<HIST>(s, limit, warp, nwarps, lane)) {
      rank_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
    } else {
      rank_tiles<WALK, HIST, L, false>(g, s, limit, warp, nwarps, lane);
    }
  } else if constexpr (WALK == kSlow) {
    if (one_round<HIST>(s, limit, warp, nwarps, lane)) {
      walk_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
    } else {
      walk_tiles<WALK, HIST, L, false>(g, s, limit, warp, nwarps, lane);
    }
  } else {
    walk_tiles<WALK, HIST, L, true>(g, s, limit, warp, nwarps, lane);
  }
}

}  // namespace rs
