// The backward search's body, one thread per query through all of its
// steps, shared by K2 (search.cu, one index) and the sharded search
// (sharded.cu, S interval shards on one card).  The two differ only in
// their rank accessor: where a step's two rows lie and what is added to
// their counts (search.cu: rs::occ_pair; sharded.cu: the owner shard's
// rows plus its prefix over the shards below).
//
// What bounds it: each step is two random row reads (the ranks of l and
// u) that depend on the previous step, so a query is a chain of dependent
// reads and the kernel is bound by their latency.  The body keeps
// everything else off that chain:
//  * The codes are read once, coalesced.  A block of kSearchThreads threads
//    owns as many consecutive queries, whose codes are one contiguous
//    [T, K] int32 tile.  The tile is staged in shared memory at once
//    (32 x 31 x 4 B = 3.9 KB), its 16-byte aligned middle by one bulk copy
//    (TMA) completing on an mbarrier, the up to 3 words on either side by
//    plain loads, so a view at any 4-byte offset works.  Each thread
//    validates its row in that pass and packs it to 2 bits a code in
//    registers (a 31-mer in one uint64); the LUT id and every step code
//    then come from registers.  Rows are read with a per-lane rotation of
//    the column order so that an even K (32) does not put a warp's lanes
//    on one shared-memory bank.
//  * The accessor issues a step's two row loads back to back.
//  * Blocks of 32 queries: a served batch of 8192 makes 256 blocks, so
//    every one of an H100's 132 SMs gets work.
//
// The k-step schedule (kstep_schedule below) is the one place the device
// code writes it; its plain form is ops/search.py::kstep_schedule.
//
// Output: half-open (l, u) per query, with empty intervals as the canonical
// (0, 0).  Input guard: every column a query's search reads must hold a
// code 1..4, and a masked query's length must lie in [1, K].  A query that
// breaks this reads no table, writes (0, 0) and adds one to *bad; so no
// input sends a read outside a table.
#pragma once

#include <cstdint>
#include <type_traits>

namespace rs {

constexpr int kSearchThreads = 32;  // queries a block
constexpr int kSearchMaxK = 256;    // columns a thread packs in registers

// The search's dynamic shared memory: the staged tile and up to 3 words of
// misalignment.
inline size_t search_smem(int K) {
  return static_cast<size_t>(kSearchThreads) * K * 4 + 16;
}

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

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

template <int K>
using Cols = std::integral_constant<int, K>;

// The k-step schedule over columns [0, r) of the packed query q: steps of
// three columns from the right while `triples`, then of two, then one
// single step at column 0 where one column is left (the leftover columns
// sit at the left, the pattern's first characters, and run last).
// step(Cols<k>(), code) takes one step of k columns and returns whether
// the interval is still nonempty; code is the columns' codes less 1 in
// base 4, the first column most significant, and for k = 1 the code
// itself (1..4, a base plane).  Steps stop at the first empty interval
// (`alive`: whether the start interval is nonempty).
template <class Q, class F>
__device__ __forceinline__ void kstep_schedule(const Q& q, int r,
                                               bool triples, bool alive,
                                               F&& step) {
  const int ntriples = triples ? r / 3 : 0;
  const int rem = r - 3 * ntriples;
  for (int j = r - 3; j >= rem && alive; j -= 3) {
    alive = step(Cols<3>(), q.at(j) * 16 + q.at(j + 1) * 4 + q.at(j + 2));
  }
  for (int j = rem - 2; j >= (rem & 1) && alive; j -= 2) {
    alive = step(Cols<2>(), q.at(j) * 4 + q.at(j + 1));
  }
  if ((rem & 1) && alive) step(Cols<1>(), q.at(0) + 1);
}

// One block of the search: queries blockIdx.x * kSearchThreads + t.
//
// codes: int32 [B, K], right-aligned base codes 1..4, 0 padding on the left.
// ks == 0: the masked 1-step search over columns < r, where r is K - p with
//   the LUT (p > 0) and K - 1 without; column j is active while
//   j >= K - lengths[b].
// ks == 2 or 3: every query has length K; triples (ks 3), then pairs, then
//   one single step.
// A: the rank accessor, with Pos its interval type:
//   lut(id, l, u)        the LUT row of prefix id;
//   start(c, l, u)       (C[c], C[c + 1]), the interval of code c alone;
//   step(Cols<k>(), code, l, u)
//                        one step: l = starts[code] + rank(code, l), and
//                        so for u, over the table of k-column planes.
// tile: the block's dynamic shared memory (search_smem(K) bytes); bar: an
// mbarrier in shared memory.  The caller stages anything else its accessor
// reads from shared memory before the call: the first __syncthreads here
// orders it.
template <int NW, class A>
__device__ __forceinline__ void search_block(
    const A& a, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ lengths, long long B, int K, int p, int ks,
    typename A::Pos* __restrict__ out_l, typename A::Pos* __restrict__ out_u,
    int32_t* __restrict__ bad, int32_t* tile, uint64_t* bar) {
  using Pos = typename A::Pos;
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kSearchThreads;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kSearchThreads), B - first));
  const long long b = first + t;
  if (t == 0) mbar_init(bar);
  int from = 0;  // first column the search reads
  int len = K;
  bool ok = true;
  if (!ks && t < rows) {
    len = lengths[b];
    ok = len >= 1 && len <= K;
    from = K - len;
    if (p > 0 && K - p < from) from = K - p;
  }
  __syncthreads();

  // pack: validate the staged row and keep it 2 bits a code
  Packed<NW> q = {};
  const int tz = min(__ffs(K) - 1, 5);   // trailing zero bits of K, <= 5
  const int rot = (t & 31) >> (5 - tz);  // lanes that share a bank differ
  const int mis = stage(codes + first * K, rows * K, tile, bar);
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

  Pos l, u;
  int r;
  if (p > 0) {
    int32_t id = 0;  // first character most significant (ops/search.py)
    for (int j = K - p; j < K; ++j) id = id * 4 + q.at(j);
    a.lut(id, l, u);
    r = K - p;
  } else {
    a.start(q.at(K - 1) + 1, l, u);  // occ(c, 0) = 0, occ(c, n) = count(c)
    r = K - 1;
  }
  if (ks) {
    kstep_schedule(q, r, ks == 3, l < u, [&](auto cols, int code) {
      a.step(cols, code, l, u);
      return l < u;
    });
  } else {
    for (int j = r - 1; j >= K - len && l < u; --j) {
      a.step(Cols<1>(), q.at(j) + 1, l, u);
    }
  }
  if (l >= u) {  // canonical empty interval
    l = 0;
    u = 0;
  }
  out_l[b] = l;
  out_u[b] = u;
}

}  // namespace rs
