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
// Two launches over the flat cells (W * NS) and lanes (W * SH) of both
// sections, a block of 256 threads per tile of 2048, eight consecutive
// cells or lanes a thread, every load of a thread issued before any is
// used: a pass waits one round of loads.  The first writes the segments
// (a thread a query, over the grid) and each tile's kept count (a block
// reduction) to a scratch buffer.  The second sums the counts of its
// section's tiles before its own (a few hundred words, from the L2): its
// first slot; it re-reads its cells or lanes (from the L2), scans the
// threads' kept counts in the block and writes each kept entry at its slot
// while the slot is below R, reading the lanes' offset and sample for kept
// lanes only; the grid fills the slots past min(total, R) with -1, and
// block 0 writes n_hist, n_hits and the refused-query count.  No scatter
// over the whole batch and no wait between blocks: the tile counts are the
// only state between the passes.  Bytes bound it: the answer's segments
// and the cells and read ids read once, offset and sample of a kept lane,
// the packed buffer written.
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
constexpr int kItems = 8;      // consecutive cells or lanes a thread
constexpr int kTile = kThreads * kItems;  // cells or lanes a block
constexpr int kMaxParts = 64;  // partitions a merge takes

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
      (static_cast<long long>(W) * NS + kTile - 1) / kTile);
  L.tiles_hits = static_cast<int>(
      (static_cast<long long>(W) * SH + kTile - 1) / kTile);
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

// One engine's answer: the search interval, the complete flags (bool),
// the histogram [W, NS] and, on the full tier, the hit lanes [W, SH];
// count = u - l, and on the histogram tier trunc = count > trunc_cap.
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
  __device__ int32_t cell(int b, int c) const {
    return hist[static_cast<long long>(b) * NS + c];
  }
  __device__ int32_t read_id(int b, int j) const {
    return rid[static_cast<long long>(b) * SH + j];
  }
  __device__ int32_t offset(int b, int j) const {
    return off[static_cast<long long>(b) * SH + j];
  }
  __device__ int32_t sample(int b, int j) const {
    return smp[static_cast<long long>(b) * SH + j];
  }
};

// A cohort's partitions: P dense buffers whose rows of stride_p words
// begin with (l, u, count, complete, hist[ns_p], (read_id, offset,
// sample)[H] each); hit lane j = p * H + h is lane h of partition p, its
// read id shifted by base_p.
struct Parts {
  int P, H;
  const int32_t* o[kMaxParts];
  int ns[kMaxParts];
  int stride[kMaxParts];
  int base[kMaxParts];

  __device__ const int32_t* row(int p, int b) const {
    return o[p] + static_cast<long long>(b) * stride[p];
  }
  __device__ void header(int b, int32_t* out, const Layout& L) const {
    long long count = 0;
    uint32_t complete = 1;
    bool trunc = false;
    for (int p = 0; p < P; ++p) {
      const int32_t* r = row(p, b);
      count += r[2];
      complete *= static_cast<uint32_t>(r[3]);
      trunc |= r[2] > H;
    }
    out[L.count + b] = static_cast<int32_t>(count & 0x7FFFFFFF);
    out[L.hi + b] = static_cast<int32_t>(count >> 31);
    out[L.complete + b] = static_cast<int32_t>(complete);
    if (L.trunc >= 0) out[L.trunc + b] = trunc;
  }
  __device__ int32_t cell(int b, int c) const {
    uint32_t v = 0;
    for (int p = 0; p < P; ++p) {
      if (c < ns[p]) v += static_cast<uint32_t>(row(p, b)[4 + c]);
    }
    return static_cast<int32_t>(v);
  }
  // column k (0 read id, 1 offset, 2 sample) of hit lane j
  __device__ int32_t hit(int b, int j, int k, int& p) const {
    p = j / H;
    return row(p, b)[4 + ns[p] + k * H + (j - p * H)];
  }
  __device__ int32_t read_id(int b, int j) const {
    int p;
    const int32_t r = hit(b, j, 0, p);
    return r >= 0 ? static_cast<int32_t>(static_cast<uint32_t>(r) +
                                         static_cast<uint32_t>(base[p]))
                  : -1;
  }
  __device__ int32_t offset(int b, int j) const {
    int p;
    return hit(b, j, 1, p);
  }
  __device__ int32_t sample(int b, int j) const {
    int p;
    return hit(b, j, 2, p);
  }
};

// The kept entries of a thread's ``kItems`` consecutive flat cells
// (section 0) or lanes (section 1) from f0, query-major as the JAX
// compaction orders them, every load issued before any is used: ``v``
// holds each item's value (the histogram cell) or read id, ``kept`` a bit
// an item → their number.
template <typename Src>
__device__ __forceinline__ int load_items(const Src& src, const Layout& L,
                                          int section, long long f0,
                                          int32_t* v, unsigned& kept) {
  const int width = section ? L.SH : L.NS;
  const long long N = static_cast<long long>(L.nq) * width;
  int b = static_cast<int>(f0 / width);
  int c = static_cast<int>(f0 - static_cast<long long>(b) * width);
  kept = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = f0 + k < N;  // a query below nq
    v[k] = in ? (section ? src.read_id(b, c) : src.cell(b, c)) : 0;
    if (in && (section ? v[k] >= 0 : v[k] > 0)) kept |= 1u << k;
    if (++c == width) {
      c = 0;
      ++b;
    }
  }
  return __popc(kept);
}

// The exclusive prefix of v over the block's threads; ``total`` their sum.
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
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? sums[w] : 0;
    total += sums[w];
  }
  return before + x - v;
}

// The block's section and tile: the cells' tiles first, then the lanes'.
__device__ __forceinline__ int section_of(const Layout& L, int& tile) {
  tile = static_cast<int>(blockIdx.x);
  if (tile < L.tiles_hist) return 0;
  tile -= L.tiles_hist;
  return 1;
}

// First pass: the segments (a thread a query, over the grid), and each
// tile's kept count into ``totals`` (the cells' tiles, then the lanes').
template <typename Src>
__global__ void __launch_bounds__(kThreads)
    pack_count_kernel(__grid_constant__ const Src src,
                      __grid_constant__ const Layout L,
                      int32_t* __restrict__ out,
                      int32_t* __restrict__ totals) {
  __shared__ int sums[kWarps];
  const int step = static_cast<int>(gridDim.x) * kThreads;
  for (int b = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
       b < L.W; b += step) {
    src.header(b, out, L);
  }
  int tile;
  const int section = section_of(L, tile);
  int32_t v[kItems];
  unsigned kept;
  const int n = load_items(src, L, section,
                           static_cast<long long>(tile) * kTile +
                               threadIdx.x * kItems, v, kept);
  int total;
  block_scan(n, sums, total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// The sums over the block of three values, on every thread; ``shared``
// (3 kWarps ints) is free again on return.
__device__ __forceinline__ void block_sum3(int* v, int* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v[i] += __shfl_down_sync(kFull, v[i], o);
    if (lane == 0) shared[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v[i] += shared[i * kWarps + w];
  }
  __syncthreads();
}

// Second pass: each kept cell and lane to its slot, the rest -1.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
    pack_fill_kernel(__grid_constant__ const Src src,
                     __grid_constant__ const Layout L,
                     int32_t* __restrict__ out,
                     const int32_t* __restrict__ totals,
                     const int32_t* __restrict__ bad) {
  __shared__ int shared[3 * kWarps];
  int tile;
  const int section = section_of(L, tile);
  const int first = section ? L.tiles_hist : 0;
  // [the section's kept entries before this tile, all cells, all lanes]
  int sum[3] = {0, 0, 0};
  for (int k = threadIdx.x; k < L.tiles_hist + L.tiles_hits; k += kThreads) {
    const int t = totals[k];
    sum[k < L.tiles_hist ? 1 : 2] += t;
    if (k >= first && k < first + tile) sum[0] += t;
  }
  block_sum3(sum, shared);
  const int before = sum[0], th = sum[1], tx = sum[2];
  const int R = L.R;
  if (before < R) {
    const long long f0 =
        static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
    int32_t v[kItems];
    unsigned kept;
    const int n = load_items(src, L, section, f0, v, kept);
    int total;
    int slot = before + block_scan(n, shared, total);
    const int width = section ? L.SH : L.NS;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((kept >> k & 1u) && slot < R) {
        const long long f = f0 + k;
        if (section) {
          const int b = static_cast<int>(f / width);
          const int j = static_cast<int>(f - static_cast<long long>(b) *
                                                 width);
          out[L.hit_idx + slot] = static_cast<int32_t>(f);
          out[L.rid + slot] = v[k];
          out[L.off + slot] = src.offset(b, j);
          out[L.smp + slot] = src.sample(b, j);
        } else {
          out[L.hist_idx + slot] = static_cast<int32_t>(f);
          out[L.hist_val + slot] = v[k];
        }
      }
      slot += kept >> k & 1u;
    }
  }
  // the slots past the kept entries: -1, over the whole grid
  const int kh = th < R ? th : R, kx = tx < R ? tx : R;
  const int step = static_cast<int>(gridDim.x) * kThreads;
  const int t0 = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  for (int s = kh + t0; s < R; s += step) {
    out[L.hist_idx + s] = -1;
    out[L.hist_val + s] = -1;
  }
  if (L.SH) {
    for (int s = kx + t0; s < R; s += step) {
      out[L.hit_idx + s] = -1;
      out[L.rid + s] = -1;
      out[L.off + s] = -1;
      out[L.smp + s] = -1;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[L.n_hist] = th > R ? -1 : th;
    if (L.SH) out[L.n_hits] = tx > R ? -1 : tx;
    out[L.bad] = bad[0];
  }
}

template <typename Src>
int launch_pack(const Src& src, const Layout& L, void* bad, void* scratch,
                void* out, cudaStream_t st) {
  auto* o = static_cast<int32_t*>(out);
  auto* t = static_cast<int32_t*>(scratch);
  const int grid = L.tiles_hist + L.tiles_hits;
  pack_count_kernel<Src><<<grid, kThreads, 0, st>>>(src, L, o, t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pack_fill_kernel<Src><<<grid, kThreads, 0, st>>>(
      src, L, o, t, static_cast<const int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// Whether the sections' flat indices and the packed buffer fit int32.
bool valid_shape(long long W, long long nq, long long NS, long long SH,
                 long long R) {
  return W >= 1 && nq >= 0 && nq <= W && NS >= 1 && SH >= 0 && R >= 0 &&
         W * NS < (1LL << 31) && W * SH < (1LL << 31) &&
         W * 6 + 6 * R + 3 < (1LL << 31);
}

long long scratch_words(const Layout& L) {
  return static_cast<long long>(L.tiles_hist) + L.tiles_hits;
}

}  // namespace

// K8: one engine's answer (l, u int32 [W]; complete bool [W]; hist int32
// [W, NS]; rid, off, smp int32 [W, SH], or all null with SH = 0) packed
// into out (int32 [out_words], the layout's size: count, complete, trunc
// where trunc_cap >= 0, l and u, the sections), trunc = u - l > trunc_cap;
// scratch int32 [scratch_words]: a word a tile of 2048 cells or lanes,
// ceil(W NS / 2048) + ceil(W SH / 2048); bad int32 [1], the
// buffer's last word.  A size that is not the layout's is refused.
extern "C" int rs_sparse_pack(const void* l, const void* u,
                              const void* complete, const void* hist,
                              long long W, int NS, const void* rid,
                              const void* off, const void* smp, int SH,
                              long long nq, long long R, int trunc_cap,
                              const void* bad, void* scratch,
                              long long scratch_words_, void* out,
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
  if (L.size != out_words || scratch_words(L) != scratch_words_) {
    return cudaErrorInvalidValue;
  }
  return launch_pack(a, L, const_cast<void*>(bad), scratch, out,
                     static_cast<cudaStream_t>(stream));
}

// The cohort merge and its pack: parts holds P device pointers to the
// partitions' int32 [W, strides[p]] buffers, strides[p] >= 4 + ns[p] (+ 3H
// where with_hits), ns, strides and bases P ints each (host arrays); NS
// the cohort's samples (>= every ns[p]); out as rs_sparse_pack's, with the count as bits 0-30 and 31+,
// trunc on the histogram tier and no l and u; scratch and bad as
// rs_sparse_pack's.
extern "C" int rs_merge_pack(const void* parts, const void* ns,
                             const void* strides, const void* bases, int P,
                             long long W, int NS,
                             int H, int with_hits, long long nq, long long R,
                             const void* bad, void* scratch,
                             long long scratch_words_, void* out,
                             long long out_words, void* stream) {
  const long long SH = with_hits ? static_cast<long long>(P) * H : 0;
  if (P < 1 || P > kMaxParts || H < 1 || !valid_shape(W, nq, NS, SH, R)) {
    return cudaErrorInvalidValue;
  }
  Parts s{};
  s.P = P, s.H = H;
  const auto* ptrs = static_cast<const int32_t* const*>(parts);
  const auto* n = static_cast<const int*>(ns);
  const auto* st = static_cast<const int*>(strides);
  const auto* b = static_cast<const int*>(bases);
  for (int p = 0; p < P; ++p) {
    if (ptrs[p] == nullptr || n[p] < 1 || n[p] > NS ||
        st[p] < 4 + n[p] + (with_hits ? 3LL * H : 0LL)) {
      return cudaErrorInvalidValue;
    }
    s.o[p] = ptrs[p];
    s.ns[p] = n[p];
    s.stride[p] = st[p];
    s.base[p] = b[p];
  }
  const Layout L = make_layout(static_cast<int>(W), static_cast<int>(nq), NS,
                               static_cast<int>(SH), static_cast<int>(R),
                               true, !with_hits, false);
  if (L.size != out_words || scratch_words(L) != scratch_words_) {
    return cudaErrorInvalidValue;
  }
  return launch_pack(s, L, const_cast<void*>(bad), scratch, out,
                     static_cast<cudaStream_t>(stream));
}
