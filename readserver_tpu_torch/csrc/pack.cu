// K8, the served answer's sparse pack, and the cohort merge with its pack.
//
// Replace the XLA ops of readserver_tpu/serve/engine.py, which the JAX
// package never wrote in Pallas:
//   K8  rs_sparse_pack   sparse_pack_device and _compact_cols (110-184):
//                        the segments of one engine's answer, then two
//                        order-preserving compactions (a cumsum, a
//                        scatter a column) of the histogram cells [W, NS]
//                        and the hit lanes [W, SH] into R slots each;
//   merge rs_merge_pack  MultiEngine._merge_full (1139-1191): the P
//                        partitions' dense [W, 4 + ns_p (+ 3H)] buffers
//                        merged (int64 count sum, product of the complete
//                        flags, histograms added into their first ns_p
//                        columns, read ids shifted by the partition's base,
//                        hit lanes concatenated, the histogram tier's
//                        truncation flag), then the same pack.
//
// The packed buffer, int32, query-major as the JAX compaction orders it:
//   [count(W), count_hi(W)?, complete(W), trunc(W)?, (l(W), u(W))?,
//    n_hist, hist_idx(R), hist_val(R),
//    (n_hits, hit_idx(R), read_id(R), offset(R), sample(R))?, bad]
// with R = cpq * W.  A kept entry is a histogram cell > 0 or a hit lane
// whose read id is >= 0, of a query below nq; the first R kept entries in
// flat order fill the slots, the slots past them hold -1, and n is the
// number kept, or -1 where more than R were (the dense fallback).  The
// dense fallbacks are not written here: the wrapper hands back the
// tensors they are made of (ops/pack.py).
//
// What bounds both: bytes.  The answer's segments and the cells and read
// ids are read once, offset and sample of a kept lane, and the packed
// buffer is written once, most of it the -1 past the kept entries.  On an
// H100 an empty launch costs 0.5-1.3 us of device time, so a second
// launch was not in itself what held the earlier two-launch design: its
// second launch re-read every cell and read id and wrote the -1 tail with
// scalar stores, and its first waited a round of loads in which each
// thread's eight consecutive items spanned 1 KB a warp.  What holds the
// one launch (scripts/torch_pack_trace.py) is a chain of round trips: the
// tile's claim, its loads, the look-back (the slowest predecessor's
// count), and the -1 tail, which waits for the sections' totals.
//
// One launch here, a single pass over the inputs.  The flat cells (nq NS)
// and lanes (nq SH) of the two sections are cut in tiles of 2048, the
// cells' tiles first.  A block takes tiles in dispatch order from a counter
// until a claim passes the last tile, on a grid of at most the blocks the
// card holds at once: every tile a block waits on, in the look-back or for
// the totals, was claimed before, by a block that runs, so no block waits
// on one the card has not started (another launch may share the card).  A
// thread takes two groups of four consecutive items, the block's groups
// side by side: 16-byte loads where the rows allow (the served rows do),
// four loads a group otherwise, every load of a tile in flight before any
// is used.  The merge sums the P
// partitions' cells of both groups partition by partition and shifts read
// ids by their partition's base, its addressing a multiply-high by the
// widths' reciprocals (no division).  A kept lane's offset and sample are
// loaded with its read id's group, before the scan.  Each tile's kept count
// is one block scan (the two groups' counts in the halves of one word);
// the block publishes it in the tile's descriptor, puts the kept entries
// at their ranks in shared memory, and writes its share of the W queries'
// segments while its predecessors publish; then it reads their descriptors
// a block's width at a time, nearest first, down to the nearest inclusive
// prefix (a decoupled look-back, one barrier a window), publishes its own
// inclusive prefix and stores the kept entries below slot R side by
// side.  Once the last tile of each section has its inclusive prefix (the
// section's total), every block writes its share of the -1 past the kept
// entries as 16-byte stores, and block 0 the n words and the refused-query
// count.  A descriptor carries the call's epoch, which the wrapper counts a
// call on each scratch, so the flags of an earlier call are stale without
// a reset; the block whose claim is the call's last sets the counter back
// to 0.  Each device and stream has its own scratch (ops/pack.py), so calls
// on two streams share no flag.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;                     // groups of 4 items a thread
constexpr int kTile = kThreads * 4 * kGroups;  // cells or lanes a tile
constexpr int kMaxParts = 64;                  // partitions a merge takes
constexpr uint32_t kInclusive = 0x80000000u;   // a descriptor's prefix bit
static_assert(kGroups == 2, "a tile's scan packs two groups in one word");

// floor(n / d) for 0 <= n < 2^31 by a multiply-high (Granlund and
// Montgomery): s = ceil(log2 d), m = floor(2^(31 + s) / d) + 1 < 2^32.
struct Div {
  uint32_t m;
  int s;

  static Div of(uint32_t d) {
    Div r{0, 0};
    while ((1ULL << r.s) < d) ++r.s;
    if (r.s) r.m = static_cast<uint32_t>((1ULL << (31 + r.s)) / d + 1);
    return r;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return s ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), m) >>
                                (s - 1))
             : n;
  }
};

// where each segment of the packed buffer starts (-1: absent)
struct Layout {
  int W, nq, NS, SH, R, tiles_hist, tiles_hits;
  long long count, hi, complete, trunc, l, u, n_hist, hist_idx, hist_val,
      n_hits, hit_idx, rid, off, smp, bad, size;
};

Layout make_layout(int W, int nq, int NS, int SH, int R, bool hi, bool trunc,
                   bool lu) {
  Layout L{};
  L.W = W, L.nq = nq, L.NS = NS, L.SH = SH, L.R = R;
  L.tiles_hist = static_cast<int>(
      (static_cast<long long>(nq) * NS + kTile - 1) / kTile);
  L.tiles_hits = static_cast<int>(
      (static_cast<long long>(nq) * SH + kTile - 1) / kTile);
  long long p = 0;
  auto seg = [&p](long long n) {
    const long long at = p;
    p += n;
    return at;
  };
  L.count = seg(W);
  L.hi = hi ? seg(W) : -1;
  L.complete = seg(W);
  L.trunc = trunc ? seg(W) : -1;
  L.l = lu ? seg(W) : -1;
  L.u = lu ? seg(W) : -1;
  L.n_hist = seg(1);
  L.hist_idx = seg(R);
  L.hist_val = seg(R);
  L.n_hits = L.hit_idx = L.rid = L.off = L.smp = -1;
  if (SH) {
    L.n_hits = seg(1);
    L.hit_idx = seg(R);
    L.rid = seg(R);
    L.off = seg(R);
    L.smp = seg(R);
  }
  L.bad = seg(1);
  L.size = p;
  return L;
}

__device__ __forceinline__ void load4(const int32_t* p, int32_t (&v)[4]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// One engine's answer: the search interval, the complete flags (bool),
// the histogram [W, NS] and, on the full tier, the hit lanes [W, SH];
// count = u - l, and on the histogram tier trunc = count > trunc_cap.  A
// flat cell or lane is its index in the row-major array.
struct Answer {
  const int32_t* l;
  const int32_t* u;
  const uint8_t* complete;
  const int32_t* hist;
  const int32_t* rid;
  const int32_t* off;
  const int32_t* smp;
  int NS, SH, trunc_cap;

  __device__ void header(int b, int32_t* out, const Layout& L) const {
    const int32_t lv = l[b], uv = u[b];
    const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(uv) -
                                           static_cast<uint32_t>(lv));
    out[L.count + b] = c;
    out[L.complete + b] = complete[b];
    if (L.trunc >= 0) out[L.trunc + b] = c > trunc_cap;
    out[L.l + b] = lv;
    out[L.u + b] = uv;
  }
  // the cells (section 0) or read ids (section 1) of the group at flat g;
  // the items at or past N are not read
  template <bool Vec>
  __device__ __forceinline__ void load(int section, int g, int N,
                                       int32_t (&v)[4]) const {
    const int32_t* a = (section ? rid : hist) + g;
    if (Vec) {
      load4(a, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = g + e < N ? __ldg(a + e) : 0;
    }
  }
  // both groups of a thread (at flat g[k]), their loads in flight together
  template <bool Vec>
  __device__ __forceinline__ void load_groups(int section,
                                              const int (&g)[kGroups], int N,
                                              int32_t (&v)[kGroups][4]) const {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      if (g[k] < N) load<Vec>(section, g[k], N, v[k]);
    }
  }
  // offset and sample of the group's kept lanes (bits of ``kept``)
  template <bool Vec>
  __device__ __forceinline__ void hit_cols(int g, unsigned kept,
                                           int32_t (&o)[4],
                                           int32_t (&s)[4]) const {
    if (Vec) {
      load4(off + g, o);
      load4(smp + g, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kept >> e & 1u) o[e] = __ldg(off + g + e), s[e] = __ldg(smp + g + e);
      }
    }
  }
};

// A cohort's partitions: P dense buffers whose rows of stride_p words
// begin with (l, u, count, complete, hist[ns_p], (read_id, offset,
// sample)[H] each); merged cell (b, c) adds the partitions' cells c <
// ns_p of row b, merged lane (b, j = p * H + h) is lane h of partition p,
// its read id shifted by base_p.
struct Parts {
  int P, H, NS, SH;
  Div by_ns, by_sh, by_h;
  const int32_t* o[kMaxParts];
  int ns[kMaxParts];
  int stride[kMaxParts];
  int base[kMaxParts];

  __device__ __forceinline__ const int32_t* row(int p, int b) const {
    return o[p] + static_cast<long long>(b) * stride[p];
  }
  __device__ void header(int b, int32_t* out, const Layout& L) const {
    long long count = 0;
    uint32_t complete = 1;
    bool trunc = false;
    for (int p = 0; p < P; ++p) {
      const int32_t* r = row(p, b);
      const int32_t c = __ldg(r + 2);
      count += c;
      complete *= static_cast<uint32_t>(__ldg(r + 3));
      trunc |= c > H;
    }
    out[L.count + b] = static_cast<int32_t>(count & 0x7FFFFFFF);
    out[L.hi + b] = static_cast<int32_t>(count >> 31);
    out[L.complete + b] = static_cast<int32_t>(complete);
    if (L.trunc >= 0) out[L.trunc + b] = trunc;
  }
  // lane f's read id in its partition p's row
  __device__ __forceinline__ const int32_t* lane(int f, int& p) const {
    const int b = by_sh(f);
    const int j = f - b * SH;
    p = by_h(j);
    return row(p, b) + 4 + ns[p] + (j - p * H);
  }
  __device__ __forceinline__ int32_t shift(int32_t r, int p) const {
    return r >= 0 ? static_cast<int32_t>(static_cast<uint32_t>(r) +
                                         static_cast<uint32_t>(base[p]))
                  : -1;
  }
  template <bool Vec>
  __device__ __forceinline__ void load(int section, int g, int N,
                                       int32_t (&v)[4]) const {
    if (section == 0 && Vec) {  // a group lies in one row, in or past ns_p
      const int b = by_ns(g);
      const int c = g - b * NS;
      uint32_t x[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        if (c < ns[p]) {
          int32_t q[4];
          load4(row(p, b) + 4 + c, q);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] += static_cast<uint32_t>(q[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = static_cast<int32_t>(x[e]);
    } else if (section == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t x = 0;
        if (g + e < N) {
          const int b = by_ns(g + e);
          const int c = g + e - b * NS;
          for (int p = 0; p < P; ++p) {
            if (c < ns[p]) {
              x += static_cast<uint32_t>(__ldg(row(p, b) + 4 + c));
            }
          }
        }
        v[e] = static_cast<int32_t>(x);
      }
    } else if (Vec) {  // a group lies in one partition's lanes
      int p;
      load4(lane(g, p), v);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = shift(v[e], p);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0;
        if (g + e < N) {
          int p;
          const int32_t* r = lane(g + e, p);
          v[e] = shift(__ldg(r), p);
        }
      }
    }
  }
  template <bool Vec>
  __device__ __forceinline__ void load_groups(int section,
                                              const int (&g)[kGroups], int N,
                                              int32_t (&v)[kGroups][4]) const {
    if (section == 0 && Vec) {  // partition by partition, both groups
      int b[kGroups], c[kGroups];
      uint32_t x[kGroups][4] = {};
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        b[k] = by_ns(g[k] < N ? g[k] : 0);
        c[k] = g[k] < N ? g[k] - b[k] * NS : NS;
      }
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        int32_t q[kGroups][4];
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          if (c[k] < ns[p]) load4(row(p, b[k]) + 4 + c[k], q[k]);
        }
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          if (c[k] < ns[p]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[k][e] += static_cast<uint32_t>(q[k][e]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[k][e] = static_cast<int32_t>(x[k][e]);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      if (g[k] < N) load<Vec>(section, g[k], N, v[k]);
    }
  }
  template <bool Vec>
  __device__ __forceinline__ void hit_cols(int g, unsigned kept,
                                           int32_t (&o)[4],
                                           int32_t (&s)[4]) const {
    if (Vec) {
      int p;
      const int32_t* r = lane(g, p);
      load4(r + H, o);
      load4(r + 2 * H, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kept >> e & 1u) {
          int p;
          const int32_t* r = lane(g + e, p);
          o[e] = __ldg(r + H), s[e] = __ldg(r + 2 * H);
        }
      }
    }
  }
};

// The exclusive prefix over the block's threads of x, whose two 16-bit
// halves scan apart (each half's block total is below 2^16); ``total``
// the block's sums.
__device__ __forceinline__ uint32_t block_scan(uint32_t x, uint32_t* sums,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t y = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t z = __shfl_up_sync(kFull, y, o);
    if (lane >= o) y += z;
  }
  if (lane == 31) sums[warp] = y;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  return before + y - x;
}

// A tile's descriptor: the call's epoch in the high word; in the low word
// the tile's kept count, or with kInclusive the section's kept entries up
// to and with the tile.  Read and written whole, past the L1.
__device__ __forceinline__ void write_desc(unsigned long long* d,
                                           uint32_t epoch, uint32_t low) {
  *reinterpret_cast<volatile unsigned long long*>(d) =
      static_cast<unsigned long long>(epoch) << 32 | low;
}

// The low word of descriptor d once it is this call's, and with the
// inclusive prefix where ``inclusive``.
__device__ __forceinline__ uint32_t await_desc(const unsigned long long* d,
                                               uint32_t epoch,
                                               bool inclusive) {
  for (;;) {
    const unsigned long long x =
        *reinterpret_cast<const volatile unsigned long long*>(d);
    if (static_cast<uint32_t>(x >> 32) == epoch &&
        (!inclusive || (static_cast<uint32_t>(x) & kInclusive))) {
      return static_cast<uint32_t>(x);
    }
    __nanosleep(32);
  }
}

// The section's kept entries before tile ``tile`` (the section's first
// tile ``first``, always inclusive): the block reads up to kThreads
// predecessors' descriptors at once, nearest first (a warp 32 of them),
// and sums their counts down to the nearest inclusive prefix, a window
// further back while the window holds none.  Each warp sums its lanes up
// to its own nearest inclusive prefix; one barrier, then every thread
// adds the warps' sums up to the first warp that holds one.  ``red``:
// 2 kWarps words.
__device__ uint32_t look_back(const unsigned long long* desc, int first,
                              int tile, uint32_t epoch, uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t before = 0;
  for (int end = tile; end > first; end -= kThreads) {
    const int i = end - 1 - static_cast<int>(threadIdx.x);
    uint32_t v = 0;
    bool inclusive = false;
    if (i >= first) {
      const uint32_t w = await_desc(desc + i, epoch, false);
      v = w & ~kInclusive;
      inclusive = (w & kInclusive) != 0;
    }
    const unsigned has = __ballot_sync(kFull, inclusive);
    // the lanes up to the warp's nearest inclusive prefix (all: none)
    const unsigned upto = has ? (2u << (__ffs(has) - 1)) - 1 : kFull;
    uint32_t sum = upto >> lane & 1u ? v : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if (lane == 0) {
      red[warp] = sum;
      red[kWarps + warp] = has != 0;
    }
    __syncthreads();
    bool found = false;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (!found) before += red[w];
      found = found || red[kWarps + w];
    }
    __syncthreads();  // ``red`` free again
    if (found) break;
  }
  return before;
}

// -1 into slots [a, R) of the column at ``col``, this block's share of
// the grid's: 16-byte stores, the few slots before and after the aligned
// stretch by block 0 (32-bit shares: the column is below 2^31 words).
__device__ __forceinline__ void fill_tail(int32_t* col, int a, int R) {
  if (a >= R) return;
  const int mis =
      static_cast<int>(reinterpret_cast<uintptr_t>(col + a) >> 2 & 3);
  const int s0 = min(R, a + ((4 - mis) & 3));
  const int n4 = (R - s0) >> 2;
  const int s1 = s0 + 4 * n4;
  if (blockIdx.x == 0) {
    if (static_cast<int>(threadIdx.x) < s0 - a) col[a + threadIdx.x] = -1;
    if (static_cast<int>(threadIdx.x) < R - s1) col[s1 + threadIdx.x] = -1;
  }
  int4* q = reinterpret_cast<int4*>(col + s0);
  const int share = (n4 + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);
  const int lo = min(n4, static_cast<int>(blockIdx.x) * share);
  const int hi = min(n4, lo + share);
  for (int k = lo + static_cast<int>(threadIdx.x); k < hi; k += kThreads) {
    q[k] = make_int4(-1, -1, -1, -1);
  }
}

// The segments of this block's share of the W queries.
template <typename Src>
__device__ __forceinline__ void write_segments(const Src& src, int32_t* out,
                                               const Layout& L) {
  const int share = (L.W + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);
  const int b0 = min(L.W, static_cast<int>(blockIdx.x) * share);
  const int b1 = min(L.W, b0 + share);
  for (int b = b0 + static_cast<int>(threadIdx.x); b < b1; b += kThreads) {
    src.header(b, out, L);
  }
}

// The whole pack in one launch (see the note at the top).  ``scratch``:
// the tile counter (its low word), then a descriptor a tile, the cells'
// tiles first.
template <typename Src, bool Vec>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(__grid_constant__ const Src src,
                __grid_constant__ const Layout L, int32_t* __restrict__ out,
                unsigned long long* __restrict__ scratch,
                const int32_t* __restrict__ bad, uint32_t epoch) {
  __shared__ uint32_t red[2 * kWarps];
  __shared__ int claimed;
  __shared__ uint32_t totals[2];
  // a tile's kept entries at their ranks: flat index, value or read id,
  // offset, sample
  __shared__ int32_t stage[4][kTile];
  auto* counter = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* desc = scratch + 1;
  const int T = L.tiles_hist + L.tiles_hits;
  bool segments = true;  // this block's segments still to write
  // A block claims until a claim passes T, one claim past it a block, so
  // the call makes T + G claims; its last sets the counter back to 0: every
  // block has made its last by then.
  const int last = T + static_cast<int>(gridDim.x) - 1;
  for (;;) {
    __syncthreads();  // ``claimed``, ``red`` and ``stage`` free again
    if (threadIdx.x == 0) {
      const int t = static_cast<int>(atomicAdd(counter, 1u));
      if (t == last) *counter = 0;
      claimed = t;
    }
    __syncthreads();
    const int tile = claimed;
    if (tile >= T) break;
    const int section = tile < L.tiles_hist ? 0 : 1;
    const int first = section ? L.tiles_hist : 0;
    const int N = L.nq * (section ? L.SH : L.NS);
    const int f0 = (tile - first) * kTile;
    int g[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      g[k] = f0 + 4 * (k * kThreads + static_cast<int>(threadIdx.x));
    }
    int32_t v[kGroups][4], o[kGroups][4], s[kGroups][4];
    unsigned kept[kGroups];
    src.template load_groups<Vec>(section, g, N, v);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      kept[k] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (g[k] + e < N && (section ? v[k][e] >= 0 : v[k][e] > 0)) {
          kept[k] |= 1u << e;
        }
      }
    }
    if (section) {
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        if (kept[k]) src.template hit_cols<Vec>(g[k], kept[k], o[k], s[k]);
      }
    }
    uint32_t total;
    const uint32_t ex = block_scan(
        __popc(kept[0]) | static_cast<uint32_t>(__popc(kept[1])) << 16, red,
        total);
    const uint32_t agg = (total & 0xFFFF) + (total >> 16);
    if (threadIdx.x == 0) {
      write_desc(desc + tile, epoch, tile == first ? agg | kInclusive : agg);
    }
    // the kept entries at their ranks in the tile
    uint32_t rank[kGroups] = {ex & 0xFFFF, (total & 0xFFFF) + (ex >> 16)};
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kept[k] >> e & 1u) {
          stage[0][rank[k]] = g[k] + e;
          stage[1][rank[k]] = v[k][e];
          if (section) {
            stage[2][rank[k]] = o[k][e];
            stage[3][rank[k]] = s[k][e];
          }
          ++rank[k];
        }
      }
    }
    // while the predecessors publish their counts: the block's segments
    if (segments) {
      write_segments(src, out, L);
      segments = false;
    }
    __syncthreads();  // ``red`` free again, ``stage`` written
    const uint32_t before =
        tile == first ? 0 : look_back(desc, first, tile, epoch, red);
    if (threadIdx.x == 0 && tile != first) {
      write_desc(desc + tile, epoch, (before + agg) | kInclusive);
    }
    // the tile's kept entries below slot R, side by side
    const uint32_t R = static_cast<uint32_t>(L.R);
    const int n = static_cast<int>(
        before >= R ? 0 : (R - before < agg ? R - before : agg));
    int32_t* at = out + before;
    const long long idx = section ? L.hit_idx : L.hist_idx;
    const long long val = section ? L.rid : L.hist_val;
    for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) {
      at[idx + i] = stage[0][i];
      at[val + i] = stage[1][i];
      if (section) {
        at[L.off + i] = stage[2][i];
        at[L.smp + i] = stage[3][i];
      }
    }
  }
  if (segments) write_segments(src, out, L);
  // every tile was claimed by a block that runs: the sections' totals come
  if (threadIdx.x < 2) {
    const bool hits = threadIdx.x == 1;
    const int last = hits ? T - 1 : L.tiles_hist - 1;
    totals[threadIdx.x] =
        (hits ? L.tiles_hits : L.tiles_hist) > 0
            ? await_desc(desc + last, epoch, true) & ~kInclusive
            : 0;
  }
  __syncthreads();
  const int th = static_cast<int>(totals[0]);
  const int tx = static_cast<int>(totals[1]);
  const int R = L.R;
  fill_tail(out + L.hist_idx, min(th, R), R);
  fill_tail(out + L.hist_val, min(th, R), R);
  if (L.SH) {
    fill_tail(out + L.hit_idx, min(tx, R), R);
    fill_tail(out + L.rid, min(tx, R), R);
    fill_tail(out + L.off, min(tx, R), R);
    fill_tail(out + L.smp, min(tx, R), R);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[L.n_hist] = th > R ? -1 : th;
    if (L.SH) out[L.n_hits] = tx > R ? -1 : tx;
    out[L.bad] = bad[0];
  }
}

// Blocks of the launch: one a tile, and enough for the segments and the
// -1 past the kept entries where the tiles are few; at most the blocks the
// card holds at once, read once per device.
template <typename Src, bool Vec>
int grid_for(const Layout& L) {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_kernel<Src, Vec>, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long tail = static_cast<long long>(L.R) * (L.SH ? 6 : 2);
  long long want = L.tiles_hist + L.tiles_hits;
  if (want < tail / (16 * kThreads)) want = tail / (16 * kThreads);
  if (want < L.W / (4 * kThreads)) want = L.W / (4 * kThreads);
  if (want > cached[dev]) want = cached[dev];
  return want < 1 ? 1 : static_cast<int>(want);
}

template <typename Src, bool Vec>
int launch(const Src& src, const Layout& L, const void* bad, void* scratch,
           int epoch, void* out, cudaStream_t st) {
  const int grid = grid_for<Src, Vec>(L);
  pack_kernel<Src, Vec><<<grid, kThreads, 0, st>>>(
      src, L, static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(scratch),
      static_cast<const int32_t*>(bad), static_cast<uint32_t>(epoch));
  return static_cast<int>(cudaGetLastError());
}

// Whether the sections' flat indices and the packed buffer fit int32.
bool valid_shape(long long W, long long nq, long long NS, long long SH,
                 long long R) {
  return W >= 1 && nq >= 0 && nq <= W && NS >= 1 && SH >= 0 && R >= 0 &&
         W * NS < (1LL << 31) && W * SH < (1LL << 31) &&
         W * 6 + 6 * R + 3 < (1LL << 31);
}

// Whether the scratch holds the counter and a descriptor a tile, and the
// epoch is one a descriptor can carry (0 is a zeroed scratch's).
bool valid_scratch(const Layout& L, long long scratch_words, int epoch) {
  return epoch >= 1 && scratch_words >= 1LL + L.tiles_hist + L.tiles_hits;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// K8: one engine's answer (l, u int32 [W]; complete bool [W]; hist int32
// [W, NS]; rid, off, smp int32 [W, SH], or all null with SH = 0) packed
// into out (int32 [out_words], the layout's size: count, complete, trunc
// where trunc_cap >= 0, l and u, the sections), trunc = u - l > trunc_cap;
// scratch int64 [scratch_words >= 1 + ceil(nq NS / 2048) + ceil(nq SH /
// 2048)], zeroed when made and used by one stream, with an epoch >= 1
// greater than its last call's; bad int32 [1], the buffer's last word.  A
// size that is not the layout's is refused.
extern "C" int rs_sparse_pack(const void* l, const void* u,
                              const void* complete, const void* hist,
                              long long W, int NS, const void* rid,
                              const void* off, const void* smp, int SH,
                              long long nq, long long R, int trunc_cap,
                              const void* bad, void* scratch,
                              long long scratch_words, int epoch, void* out,
                              long long out_words, void* stream) {
  if (!valid_shape(W, nq, NS, SH, R) ||
      (SH && (rid == nullptr || off == nullptr || smp == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Answer a{};
  a.l = static_cast<const int32_t*>(l);
  a.u = static_cast<const int32_t*>(u);
  a.complete = static_cast<const uint8_t*>(complete);
  a.hist = static_cast<const int32_t*>(hist);
  a.rid = static_cast<const int32_t*>(rid);
  a.off = static_cast<const int32_t*>(off);
  a.smp = static_cast<const int32_t*>(smp);
  a.NS = NS, a.SH = SH, a.trunc_cap = trunc_cap;
  const Layout L = make_layout(static_cast<int>(W), static_cast<int>(nq), NS,
                               SH, static_cast<int>(R), false,
                               trunc_cap >= 0, true);
  if (L.size != out_words || !valid_scratch(L, scratch_words, epoch)) {
    return cudaErrorInvalidValue;
  }
  // 16-byte groups: the arrays aligned and of whole groups
  const bool vec = aligned16(hist) && W * NS % 4 == 0 &&
                   (SH == 0 || (aligned16(rid) && aligned16(off) &&
                                aligned16(smp) && W * SH % 4 == 0));
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<Answer, true>(a, L, bad, scratch, epoch, out, st)
             : launch<Answer, false>(a, L, bad, scratch, epoch, out, st);
}

// The cohort merge and its pack: parts holds P device pointers to the
// partitions' int32 [W, strides[p]] buffers, strides[p] >= 4 + ns[p] (+ 3H
// where with_hits), ns, strides and bases P ints each (host arrays); NS
// the cohort's samples (>= every ns[p]); out as rs_sparse_pack's, with the
// count as bits 0-30 and 31+, trunc on the histogram tier and no l and u;
// scratch, epoch and bad as rs_sparse_pack's.
extern "C" int rs_merge_pack(const void* parts, const void* ns,
                             const void* strides, const void* bases, int P,
                             long long W, int NS, int H, int with_hits,
                             long long nq, long long R, const void* bad,
                             void* scratch, long long scratch_words,
                             int epoch, void* out, long long out_words,
                             void* stream) {
  const long long SH = with_hits ? static_cast<long long>(P) * H : 0;
  if (P < 1 || P > kMaxParts || H < 1 || !valid_shape(W, nq, NS, SH, R)) {
    return cudaErrorInvalidValue;
  }
  Parts s{};
  s.P = P, s.H = H, s.NS = NS, s.SH = static_cast<int>(SH);
  s.by_ns = Div::of(static_cast<uint32_t>(NS));
  s.by_sh = Div::of(static_cast<uint32_t>(SH > 0 ? SH : 1));
  s.by_h = Div::of(static_cast<uint32_t>(H));
  const auto* ptrs = static_cast<const int32_t* const*>(parts);
  const auto* n = static_cast<const int*>(ns);
  const auto* st = static_cast<const int*>(strides);
  const auto* b = static_cast<const int*>(bases);
  // 16-byte groups: every row's cells and lanes start aligned, a group
  // lies in one row, and in or past each partition's samples
  bool vec = NS % 4 == 0 && (!with_hits || H % 4 == 0);
  for (int p = 0; p < P; ++p) {
    if (ptrs[p] == nullptr || n[p] < 1 || n[p] > NS ||
        st[p] < 4 + n[p] + (with_hits ? 3LL * H : 0LL)) {
      return cudaErrorInvalidValue;
    }
    s.o[p] = ptrs[p];
    s.ns[p] = n[p];
    s.stride[p] = st[p];
    s.base[p] = b[p];
    vec = vec && aligned16(ptrs[p]) && st[p] % 4 == 0 && n[p] % 4 == 0;
  }
  const Layout L = make_layout(static_cast<int>(W), static_cast<int>(nq), NS,
                               static_cast<int>(SH), static_cast<int>(R),
                               true, !with_hits, false);
  if (L.size != out_words || !valid_scratch(L, scratch_words, epoch)) {
    return cudaErrorInvalidValue;
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  return vec ? launch<Parts, true>(s, L, bad, scratch, epoch, out, cs)
             : launch<Parts, false>(s, L, bad, scratch, epoch, out, cs);
}
