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
// bytes.  The walks, and K7 through them, are chains of dependent row reads
// and one terminal read; walk.cuh holds their persistent sweep (tiles of
// 32, lane refill, terminal reads as lane states, K7's tile mapping of
// slots to queries) and, for the marks, lf and slow walks, rank_tiles: a
// hot loop of the step alone, the one-round step counting one plane in
// 32-bit row offsets, and the one/two-round switch at the crossover
// measured on the card (g_one_max).  This file is its table accessor over
// one index (Walk), the kernels and the entry points.  64 registers a
// thread (kMinBlocks); ptxas spills a few bytes only in the fused walk at
// 8 words a block.
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
#include "walk.cuh"

namespace {

using rs::kDsa;
using rs::kFused;
using rs::kLf;
using rs::kMarks;
using rs::kSlow;

constexpr int kThreads = rs::kSweepThreads;  // persistent blocks of 4 warps
constexpr int kMinBlocks = 8;  // per SM: 64 registers a thread, no spill

// The walks a warp up to which the marks and slow walks step in one round
// (walk.cuh's sweep); rs_walk_one_round_max sets it, for the A/B script's
// sweep of the crossover.
int g_one_max = rs::kOneRoundMax;

// Everything a walk reads, and walk.cuh's table accessor over one index;
// each kind reads its own tables:
//   dsa:   one word per SA row;
//   fused: rows of fused_words uint32 words per block of (1 << log2_block)
//          symbols: [occ ckpt c=0..4, mark ckpt, dollar plane, base-low
//          plane, base-high plane, mark plane, pad]
//          (index/packing.pack_fused_rows);
//   marks, slow: the base rank table (rank.cuh's layout, planes c = 0..4)
//          and the sym4 words (8 symbols a word, 4 bits each);
//   marks, lf: the mark table, one plane of that layout (pack_bit_rank);
//   lf:    one int32 a row, the LF value with the sign bit set where sampled.
// A key looked up (a pair's slot, a $-rank, a read id) is clipped to its
// table, as the plain forms clip it.
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
  const int32_t* read_to_sample;  // K7
  long long num_reads;
  long long plane_words;  // rank: words between two planes (rank_tiles)

  using Pos = int32_t;
  struct Loc {
    int32_t row;
  };
  static constexpr bool kSample = false;
  static constexpr bool kRankTiles = true;  // the rank walks: rank_tiles

  __device__ __forceinline__ int32_t from_input(int32_t row) const {
    return row;
  }
  __device__ __forceinline__ Loc at(int32_t row) const { return {row}; }
  __device__ __forceinline__ bool inside(int32_t) const { return true; }
  __device__ __forceinline__ int32_t outside_drank(int32_t) const { return 0; }
  __device__ __forceinline__ int32_t local(Loc x) const { return x.row; }
  __device__ __forceinline__ const uint32_t* rank_row(Loc x, int c) const {
    return rs::row_ptr(rank, c, x.row >> layout.log2_block, layout);
  }
  __device__ __forceinline__ const uint32_t* mark_row(Loc x) const {
    return rs::row_ptr(marks, 0, x.row >> layout.log2_block, layout);
  }
  __device__ __forceinline__ int32_t lf_word(Loc x) const {
    return __ldg(lf + x.row);
  }
  __device__ __forceinline__ uint32_t sym4_word(Loc x) const {
    return __ldg(sym4 + (x.row >> 3));
  }
  __device__ __forceinline__ int32_t rank_of(Loc, int, int32_t n) const {
    return n;
  }
  __device__ __forceinline__ long long mark_slot(Loc, int32_t n) const {
    return n;
  }
  __device__ __forceinline__ int2 pair(long long slot) const {
    return __ldg(reinterpret_cast<const int2*>(pairs) +
                 rs::clip_index(slot, n_pairs));
  }
  __device__ __forceinline__ int32_t dollar(long long drank) const {
    return __ldg(dollar_map + rs::clip_index(drank, n_dollar));
  }
  __device__ __forceinline__ int32_t sample(long long rid) const {
    return __ldg(read_to_sample + rs::clip_index(rid, num_reads));
  }
  __device__ __forceinline__ uint32_t dsa_word(int32_t row) const {
    return __ldg(dsa + row);
  }
  __device__ __forceinline__ int32_t C_at(int c) const { return __ldg(C + c); }
  // LF values below C[1] (the $ count) are $ rows' $-ranks
  __device__ __forceinline__ int32_t dollar_limit() const {
    return __ldg(C + 1);
  }
};

// dsa[row] = read_id << bits | offset, a uint32: the shift is logical, so a
// word with bit 31 set (read ids past 2^(31 - bits)) still gives its id.
__device__ __forceinline__ void dsa_decode(const Walk& g, int32_t row,
                                           int32_t& rid, int32_t& off) {
  const uint32_t p = __ldg(g.dsa + row);
  rid = static_cast<int32_t>(p >> g.dsa_bits);
  off = static_cast<int32_t>(p & ((1u << g.dsa_bits) - 1u));
}

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
        smp = __ldg(read_to_sample + rs::clip_index(rid, num_reads));
      }
    }
    rid_out[k] = rid;
    off_out[k] = off;
    if (smp_out != nullptr) smp_out[k] = smp;
  }
}

// ------------------------------------------------- the sweep: walks and K7

template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resolve_fused_kernel(Walk g, rs::Sweep<int32_t> s) {
  rs::sweep<kFused, false, W>(g, s);
}

template <int WALK, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resolve_walk_kernel(Walk g, rs::Sweep<int32_t> s) {
  rs::sweep<WALK, false, L>(g, s);
}

template <int WALK, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    exact_histogram_kernel(Walk g, rs::Sweep<int32_t> s) {
  rs::sweep<WALK, true, L>(g, s);
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
void launch_sweep(F kernel, const Walk& g, const rs::Sweep<int32_t>& s,
                  long long max_slots, cudaStream_t st) {
  const unsigned grid = persistent_grid(
      kernel, max_slots < 0 ? (1LL << 20) : (max_slots + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, st>>>(g, s);
}

// One sweep kernel: K7 (HIST) or a walk kernel, for the walk and layout.
template <bool HIST, int WALK, int L>
void launch_one(const Walk& g, const rs::Sweep<int32_t>& s, long long max_slots,
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
void launch_rank(const Walk& g, const rs::Sweep<int32_t>& s, long long max_slots,
                 cudaStream_t st) {
  if (g.layout.row_words == 4) {
    launch_one<HIST, WALK, 1>(g, s, max_slots, st);
  } else {
    launch_one<HIST, WALK, 0>(g, s, max_slots, st);
  }
}

template <int W>
bool fused_layout_ok(int fused_words) {
  return fused_words == rs::FusedRow<W>::R;
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
      // rank_tiles forms the rank and mark tables' word offsets in 32 bits
      return y.words_per_block >= 1 && y.row_words >= y.words_per_block + 1 &&
             (y.words_per_block << 5) == (1 << y.log2_block) &&
             g.plane_words * 5 < (1LL << 31);
    default:
      return false;
  }
}

template <bool HIST>
void launch(int kind, const Walk& g, const rs::Sweep<int32_t>& s, long long max_slots,
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
        static_cast<const int32_t*>(pairs), n_pairs, max_steps, nullptr, 0,  \
        rows_per_symbol * row_words                                          \
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
  rs::Sweep<int32_t> s{};
  s.rows = static_cast<const int32_t*>(rows);
  s.valid = static_cast<const uint8_t*>(valid);
  s.R = R;
  s.rid_out = static_cast<int32_t*>(rid);
  s.off_out = static_cast<int32_t*>(off);
  s.one_max = g_one_max;
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
  Walk g = RS_WALK_OF_PARAMS;
  g.read_to_sample = static_cast<const int32_t*>(read_to_sample);
  g.num_reads = num_reads;
  if (!walk_ok(kind, true, g) || (kind != kDsa && g.max_steps < 1)) {
    return cudaErrorInvalidValue;
  }
  rs::Sweep<int32_t> s{};
  s.l = static_cast<const int32_t*>(l);
  s.cum = static_cast<const long long*>(cum);
  s.B = B;
  s.cap = cap;
  s.S = S;
  s.hist = static_cast<int32_t*>(hist);
  s.one_max = g_one_max;
  launch<true>(kind, g, s, cap, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Sets the walks a warp up to which the marks and slow walks step in one
// round (a negative value leaves it); returns the value it had.
extern "C" int rs_walk_one_round_max(int walks) {
  const int was = g_one_max;
  if (walks >= 0) g_one_max = walks;
  return was;
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
