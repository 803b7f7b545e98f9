// K2: backward search, one thread per query through all of its steps.
//
// Replaces the XLA loops of readserver_tpu/ops/search.py: _scan_steps
// (lines 93-145, the masked 1-step search behind backward_search and
// backward_search_lut) and backward_search_pair (lines 220-337, the k-step
// schedule: optional LUT start, triples over rank3_rows/C3, then one pair
// over rank2_rows/C2, then one single step at the left edge).  The JAX
// package advances the whole batch one step per XLA gather and cannot fuse
// across steps (kernels/pallas_rank.py:23-27); here one thread carries one
// query from its start interval to its answer with (l, u) in registers.
//
// What bounds it: each step is two 16-byte random reads (the ranks of l and
// u) that depend on the previous step, so a query is a chain of dependent
// HBM reads and the kernel is bound by their latency.  The design keeps
// everything else off that chain:
//  * The codes are read once, coalesced.  A block of T threads owns T
//    consecutive queries, whose codes are one contiguous [T, K] int32 tile.
//    The tile is staged in shared memory at once (32 x 31 x 4 B = 3.9 KB,
//    so the 32 blocks an SM holds fit), its 16-byte aligned middle by one
//    bulk copy (TMA) completing on an mbarrier, the up to 3 words on either
//    side by plain loads, so a view at any 4-byte offset works.  Each thread validates its row in that
//    pass and packs it to 2 bits a code in registers (a 31-mer in one
//    uint64); the LUT id and every step code then come from registers.
//    Rows are read with a per-lane rotation of the column order so that an
//    even K (32) does not put a warp's lanes on one shared-memory bank.
//  * Each step issues its two row loads back to back (rs::occ_pair).
//  * The guard count goes to *bad on the card; the wrapper decides whether
//    to wait for it (the engine reads it with its one result copy).
//  * Blocks of kThreads = 32 queries: a served batch of 8192 makes 256
//    blocks, so every one of an H100's 132 SMs gets work.  Block sizes 32
//    to 256 timed within 3% of each other at widths 8192 and 262,144.
//
// Output: half-open (l, u) per query, with empty intervals as the canonical
// (0, 0) — the same bits as the plain torch forms in ops/search.py.
//
// Input guard: every column a query's search reads must hold a code 1..4,
// and a masked query's length must lie in [1, K].  A query that breaks this
// reads no table, writes (0, 0) and adds one to *bad; so no input sends a
// read outside a table.

#include <climits>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kMaxK = 256;     // columns a thread packs in registers
constexpr int kThreads = 32;   // queries a block

// One query's codes, 2 bits each (code - 1): column j at bits 2 (j & 31) of
// word j >> 5.  NW is a compile-time count, so the words stay in registers
// (each access is a chain of selects, never a local-memory index).
template <int NW>
struct Packed {
  uint64_t w[NW];

  __device__ __forceinline__ void set(int j, uint32_t v) {
    const uint64_t bits = static_cast<uint64_t>(v) << (2 * (j & 31));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if ((j >> 5) == k) w[k] |= bits;
    }
  }

  // code - 1, in 0..3
  __device__ __forceinline__ int at(int j) const {
    uint64_t word = w[0];
#pragma unroll
    for (int k = 1; k < NW; ++k) {
      if ((j >> 5) == k) word = w[k];
    }
    return static_cast<int>((word >> (2 * (j & 31))) & 3u);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Stage words [0, nwords) of src into shared memory, word w at
// smem[w + mis] with mis = (src / 4) % 4, so that src's 16-byte aligned
// words land on 16-byte aligned shared addresses.  The aligned middle goes
// as one bulk copy on `bar` (its first phase), the words before and after it
// as plain loads.  Called by every thread of the block; on return every
// staged word is visible to every thread.  Returns mis.
__device__ __forceinline__ int stage(const int32_t* __restrict__ src,
                                     int nwords, int32_t* smem,
                                     uint64_t* bar) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - mis) & 3, nwords);
  const int mid = ((nwords - head) >> 2) << 2;
  const int tail = nwords - head - mid;
  const int t = threadIdx.x;
  if (t == 0) {
    const uint32_t b = smem_addr(bar);
    if (mid > 0) {
      // order earlier generic-proxy accesses of the buffer before the copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "{\n .reg .b64 st;\n"
          " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
              b),
          "r"(mid * 4)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem + mis + head)),
          "l"(src + head), "r"(mid * 4), "r"(b)
          : "memory");
    } else {
      asm volatile(
          "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
          ::"r"(b)
          : "memory");
    }
  } else if (t <= 3) {
    if (t - 1 < head) smem[mis + t - 1] = src[t - 1];
  } else if (t <= 6) {
    const int w = head + mid + t - 4;
    if (t - 4 < tail) smem[mis + w] = src[w];
  }
  __syncthreads();
  mbar_wait(bar, 0);
  return mis;
}

__device__ __forceinline__ void step(const uint32_t* __restrict__ table,
                                     int32_t start, int code,
                                     const rs::Layout& g, int32_t& l,
                                     int32_t& u) {
  int32_t ol, ou;
  rs::occ_pair(table, code, l, u, g, ol, ou);
  l = start + ol;
  u = start + ou;
}

// codes: int32 [B, K], right-aligned base codes 1..4, 0 padding on the left.
// kstep == 0: masked 1-step search over columns < r where r is K - p with a
//   LUT and K - 1 without; column j is active while j >= K - lengths[b].
// kstep != 0: every query has length K; triples (when rank3_rows is given),
//   then pairs, then one single step.
// Dynamic shared memory: kThreads * K * 4 + 16 bytes (the staged tile and
// up to 3 words of misalignment).
template <int NW>
__global__ void __launch_bounds__(kThreads) backward_search_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    long long B, int K, const int32_t* __restrict__ C,
    const uint32_t* __restrict__ rank_rows, const int32_t* __restrict__ lut,
    int p, const uint32_t* __restrict__ rank2_rows,
    const int32_t* __restrict__ C2, const uint32_t* __restrict__ rank3_rows,
    const int32_t* __restrict__ C3, int kstep, rs::Layout g,
    int32_t* __restrict__ out_l, int32_t* __restrict__ out_u,
    int32_t* __restrict__ bad) {
  extern __shared__ __align__(16) int32_t tile[];
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kThreads), B - first));
  const long long b = first + t;
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int from = 0;  // first column the search reads
  int len = K;
  bool ok = true;
  if (!kstep && t < rows) {
    len = lengths[b];
    ok = len >= 1 && len <= K;
    from = K - len;
    if (lut != nullptr && K - p < from) from = K - p;
  }
  __syncthreads();

  // pack: validate the staged row and keep it 2 bits a code
  Packed<NW> q = {};
  const int tz = min(__ffs(K) - 1, 5);   // trailing zero bits of K, <= 5
  const int rot = (t & 31) >> (5 - tz);  // lanes that share a bank differ
  const int mis = stage(codes + first * K, rows * K, tile, &bar);
  if (t >= rows) return;
  const int32_t* mine = tile + mis + t * K;
  for (int jj = 0; jj < K; ++jj) {
    int j = jj + rot;
    if (j >= K) j -= K;
    const int v = mine[j] - 1;
    if (j >= from) {
      ok = ok && static_cast<unsigned>(v) <= 3u;
      q.set(j, static_cast<uint32_t>(v) & 3u);
    }
  }
  if (!ok) {
    atomicAdd(bad, 1);
    out_l[b] = 0;
    out_u[b] = 0;
    return;
  }

  int32_t l, u;
  int r;
  if (lut != nullptr) {
    int32_t id = 0;  // first character most significant (ops/search.py)
    for (int j = K - p; j < K; ++j) id = id * 4 + q.at(j);
    const int2 lu = __ldg(reinterpret_cast<const int2*>(lut) + id);
    l = lu.x;
    u = lu.y;
    r = K - p;
  } else {
    const int c = q.at(K - 1) + 1;  // first step is free: occ(c, 0), occ(c, n)
    l = __ldg(C + c);
    u = __ldg(C + c + 1);
    r = K - 1;
  }
  if (kstep) {
    const int ntriples = rank3_rows != nullptr ? r / 3 : 0;
    const int rem = r - 3 * ntriples;
    for (int j = r - 3; j >= rem && l < u; j -= 3) {
      const int code = q.at(j) * 16 + q.at(j + 1) * 4 + q.at(j + 2);
      step(rank3_rows, __ldg(C3 + code), code, g, l, u);
    }
    for (int j = rem - 2; j >= (rem & 1) && l < u; j -= 2) {
      const int code = q.at(j) * 4 + q.at(j + 1);
      step(rank2_rows, __ldg(C2 + code), code, g, l, u);
    }
    if ((rem & 1) && l < u) {
      const int c = q.at(0) + 1;
      step(rank_rows, __ldg(C + c), c, g, l, u);
    }
  } else {
    for (int j = r - 1; j >= K - len && l < u; --j) {
      const int c = q.at(j) + 1;
      step(rank_rows, __ldg(C + c), c, g, l, u);
    }
  }
  if (l >= u) {  // canonical empty interval
    l = 0;
    u = 0;
  }
  out_l[b] = l;
  out_u[b] = u;
}

template <int NW>
int launch(const void* codes, const void* lengths, long long B, int K,
           const void* C, const void* rank_rows, const void* lut, int p,
           const void* rank2_rows, const void* C2, const void* rank3_rows,
           const void* C3, int kstep, const rs::Layout& g, void* out_l,
           void* out_u, void* bad, long long blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kThreads) * K * 4 + 16;
  backward_search_kernel<NW><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(lengths),
      B, K, static_cast<const int32_t*>(C),
      static_cast<const uint32_t*>(rank_rows),
      static_cast<const int32_t*>(lut), p,
      static_cast<const uint32_t*>(rank2_rows),
      static_cast<const int32_t*>(C2),
      static_cast<const uint32_t*>(rank3_rows),
      static_cast<const int32_t*>(C3), kstep, g,
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_u),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K in [1, 256].
extern "C" int rs_backward_search(
    const void* codes, const void* lengths, long long B, int K, const void* C,
    const void* rank_rows, const void* lut, int p, const void* rank2_rows,
    const void* C2, const void* rank3_rows, const void* C3, int kstep,
    long long rows_per_symbol, int log2_block, int words_per_block,
    int row_words, void* out_l, void* out_u, void* bad, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + kThreads - 1) / kThreads;
  if (K < 1 || K > kMaxK || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rs::Layout g{rows_per_symbol, log2_block, words_per_block, row_words};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_LAUNCH(NW)                                                        \
  launch<NW>(codes, lengths, B, K, C, rank_rows, lut, p, rank2_rows, C2,     \
             rank3_rows, C3, kstep, g, out_l, out_u, bad, blocks, s)
  if (K <= 32) return RS_LAUNCH(1);
  if (K <= 64) return RS_LAUNCH(2);
  if (K <= 128) return RS_LAUNCH(4);
  return RS_LAUNCH(8);
#undef RS_LAUNCH
}
