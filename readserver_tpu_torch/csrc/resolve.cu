// K5-K7: resolve SA rows to (read id, offset), and exact per-sample
// histograms over whole query intervals.
//
// Replaces the XLA loops of readserver_tpu/ops/resolve.py, which the JAX
// package never wrote in Pallas:
//   K5 rs_resolve_dsa      expand_intervals (74) + resolve_rows_dsa (222)
//                          + the engine's read_to_sample gather
//                          (serve/engine.py:548-561);
//   K6 rs_resolve_fused    resolve_rows_fused + _fused_step_fields
//                          (258-342);
//   K7 rs_exact_histogram  exact_sample_histogram (426-499).
// The JAX lanes step in lockstep with frozen `done` lanes; here a thread
// carries its row through the walk and stops at its terminal, which gives
// the same answers.
//
// What bounds them: K5 is one random 4-byte read per hit lane; K6 is a chain
// of at most sample_rate dependent 64-byte row reads per row (latency-bound,
// so one thread per row keeps as many chains in flight as there are rows);
// K7 is K5 or K6 per worklist slot plus a binary search over the query
// prefix sums (which stay in L1/L2) and one atomic add.  Nothing is staged in
// shared memory.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each entry point runs on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a layout it does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"

namespace {

// Everything a walk reads.  dsa: one word per SA row.  fused: rows of
// fused_words uint32 words per block of (1 << log2_block) symbols:
//   [occ ckpt c=0..4, mark ckpt, dollar plane, base-low plane,
//    base-high plane, mark plane, pad]   (index/packing.pack_fused_rows)
struct Walk {
  const uint32_t* dsa;
  int dsa_bits;
  const uint32_t* fused;
  int fused_words;
  int log2_block;
  const int32_t* C;
  const int32_t* dollar_map;
  long long n_dollar;
  const int32_t* pairs;  // [n_pairs, 2] (read id, offset)
  long long n_pairs;
  int sample_rate;
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

  // the bit at `within` of the plane starting at word OFF
  template <int OFF>
  __device__ __forceinline__ uint32_t bit(int within) const {
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if ((within >> 5) == k) b = (w[OFF + k] >> (within & 31)) & 1u;
    }
    return b;
  }

  // set bits of the plane at OFF among its first `within` positions
  template <int OFF>
  __device__ __forceinline__ uint32_t pop(int within) const {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      acc += __popc(w[OFF + k] & rs::low_mask(rs::clamp_bits(within - 32 * k)));
    }
    return acc;
  }

  // occ(c, pos) for a base c = 1 + lo + 2 hi: XNOR-match of the base planes
  // against c's bits, with $ positions (zero base planes) masked out
  __device__ __forceinline__ uint32_t base_occ(uint32_t lo, uint32_t hi,
                                               int within) const {
    const uint32_t t0 = lo ? 0xFFFFFFFFu : 0u, t1 = hi ? 0xFFFFFFFFu : 0u;
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t m =
          ~(w[LO + k] ^ t0) & ~(w[HI + k] ^ t1) & ~w[DOLLAR + k];
      acc += __popc(m & rs::low_mask(rs::clamp_bits(within - 32 * k)));
    }
    const int c = 1 + static_cast<int>(lo) + 2 * static_cast<int>(hi);
    const uint32_t ck = c == 1 ? w[1] : (c == 2 ? w[2] : (c == 3 ? w[3] : w[4]));
    return ck + acc;
  }
};

// The fused-row walk of one row: at most sample_rate steps; the first row
// that is marked or holds a $ ends it (marked wins).  A walk that has not
// ended after sample_rate steps gives -1, as the JAX loop's undone lanes do.
template <int W>
__device__ __forceinline__ void fused_walk(const Walk& g, int32_t cur,
                                           int32_t& rid, int32_t& off) {
  const int32_t mask = (1 << g.log2_block) - 1;
  for (int steps = 0; steps < g.sample_rate; ++steps) {
    FusedRow<W> r;
    r.load(g.fused + static_cast<size_t>(cur >> g.log2_block) *
                         static_cast<size_t>(g.fused_words));
    const int within = cur & mask;
    const uint32_t marked = r.template bit<FusedRow<W>::MARK>(within);
    const uint32_t dollar = r.template bit<FusedRow<W>::DOLLAR>(within);
    if (marked) {
      const int32_t slot = static_cast<int32_t>(
          r.w[5] + r.template pop<FusedRow<W>::MARK>(within));
      const int2 pr = __ldg(reinterpret_cast<const int2*>(g.pairs) +
                            clip_index(slot, g.n_pairs));
      rid = pr.x;
      off = pr.y + steps;
      return;
    }
    if (dollar) {  // occ($, cur) is the $-rank, the dollar_map key
      const int32_t o = static_cast<int32_t>(
          r.w[0] + r.template pop<FusedRow<W>::DOLLAR>(within));
      rid = __ldg(g.dollar_map + clip_index(o, g.n_dollar));
      off = steps;
      return;
    }
    const uint32_t lo = r.template bit<FusedRow<W>::LO>(within);
    const uint32_t hi = r.template bit<FusedRow<W>::HI>(within);
    const int c = 1 + static_cast<int>(lo) + 2 * static_cast<int>(hi);
    cur = __ldg(g.C + c) + static_cast<int32_t>(r.base_occ(lo, hi, within));
  }
  rid = -1;
  off = -1;
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
        smp = __ldg(read_to_sample + clip_index(rid, num_reads));
      }
    }
    rid_out[k] = rid;
    off_out[k] = off;
    if (smp_out != nullptr) smp_out[k] = smp;
  }
}

// ------------------------------------------------------------------ K6

template <int W>
__global__ void resolve_fused_kernel(const int32_t* __restrict__ rows,
                                     const uint8_t* __restrict__ valid,
                                     long long R, Walk g,
                                     int32_t* __restrict__ rid_out,
                                     int32_t* __restrict__ off_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < R; k += stride) {
    int32_t rid = -1, off = -1;
    if (valid[k]) fused_walk<W>(g, __ldg(rows + k), rid, off);
    rid_out[k] = rid;
    off_out[k] = off;
  }
}

// ------------------------------------------------------------------ K7

// Worklist slot s (of the concatenated intervals) → its query q (the
// right-sided search: the first q with cum[q] > s) and SA row
// l[q] + (s - cum[q - 1]); the row's read → sample → hist[q * S + sample].
// Slots at or past min(total, cap) do nothing (cap < 0: no cap).
template <int KIND, int W>
__global__ void exact_histogram_kernel(
    const int32_t* __restrict__ l, const long long* __restrict__ cum,
    long long B, long long cap, long long slots, Walk g,
    const int32_t* __restrict__ read_to_sample, long long num_reads, int S,
    int32_t* __restrict__ hist) {
  const long long total = __ldg(cum + B - 1);
  const long long limit = cap < 0 ? total : (total < cap ? total : cap);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < slots && s < limit; s += stride) {
    long long lo = 0, hi = B;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) <= s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long q = lo < B - 1 ? lo : B - 1;
    const long long prev = q > 0 ? __ldg(cum + q - 1) : 0;
    const int32_t row = __ldg(l + q) + static_cast<int32_t>(s - prev);
    int32_t rid, off;
    if (KIND == 0) {
      dsa_decode(g, row, rid, off);
    } else {
      fused_walk<W>(g, row, rid, off);
    }
    // an unterminated walk (-1) clips to read 0, as the JAX package does
    const long long seg =
        q * S + __ldg(read_to_sample + clip_index(rid, num_reads));
    if (seg >= 0 && seg < B * S) atomicAdd(hist + seg, 1);
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

Walk make_walk(const void* dsa, int dsa_bits, const void* fused,
               int fused_words, int log2_block, const void* C,
               const void* dollar_map, long long n_dollar, const void* pairs,
               long long n_pairs, int sample_rate) {
  return Walk{static_cast<const uint32_t*>(dsa),
              dsa_bits,
              static_cast<const uint32_t*>(fused),
              fused_words,
              log2_block,
              static_cast<const int32_t*>(C),
              static_cast<const int32_t*>(dollar_map),
              n_dollar,
              static_cast<const int32_t*>(pairs),
              n_pairs,
              sample_rate};
}

template <int W>
bool fused_layout_ok(int fused_words) {
  return fused_words == FusedRow<W>::R;
}

bool fused_ok(int words_per_block, int fused_words) {
  switch (words_per_block) {
    case 1: return fused_layout_ok<1>(fused_words);
    case 2: return fused_layout_ok<2>(fused_words);
    case 4: return fused_layout_ok<4>(fused_words);
    case 8: return fused_layout_ok<8>(fused_words);
    default: return false;
  }
}

}  // namespace

extern "C" int rs_resolve_dsa(const void* l, const void* u, long long B,
                              int H, const void* dsa, int dsa_bits,
                              const void* read_to_sample, long long num_reads,
                              void* rid, void* off, void* smp, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dsa_bits < 1 || dsa_bits > 31) return cudaErrorInvalidValue;
  const Walk g = make_walk(dsa, dsa_bits, nullptr, 0, 0, nullptr, nullptr, 0,
                           nullptr, 0, 0);
  const int threads = 256;
  resolve_dsa_kernel<<<grid_for(B * H, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(u), B, H, g,
      static_cast<const int32_t*>(read_to_sample), num_reads,
      static_cast<int32_t*>(rid), static_cast<int32_t*>(off),
      static_cast<int32_t*>(smp));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_resolve_fused(const void* rows, const void* valid,
                                long long R, const void* fused,
                                int fused_words, int log2_block,
                                int words_per_block, const void* C,
                                const void* dollar_map, long long n_dollar,
                                const void* pairs, long long n_pairs,
                                int sample_rate, void* rid, void* off,
                                void* stream) {
  if (R <= 0) return 0;
  if (!fused_ok(words_per_block, fused_words)) return cudaErrorInvalidValue;
  const Walk g = make_walk(nullptr, 0, fused, fused_words, log2_block, C,
                           dollar_map, n_dollar, pairs, n_pairs, sample_rate);
  const int threads = 128;
  const unsigned grid = grid_for(R, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* ro = static_cast<int32_t*>(rid);
  int32_t* oo = static_cast<int32_t*>(off);
  switch (words_per_block) {
    case 1: resolve_fused_kernel<1><<<grid, threads, 0, st>>>(r, v, R, g, ro, oo); break;
    case 2: resolve_fused_kernel<2><<<grid, threads, 0, st>>>(r, v, R, g, ro, oo); break;
    case 4: resolve_fused_kernel<4><<<grid, threads, 0, st>>>(r, v, R, g, ro, oo); break;
    case 8: resolve_fused_kernel<8><<<grid, threads, 0, st>>>(r, v, R, g, ro, oo); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_exact_histogram(
    const void* l, const void* cum, long long B, long long cap,
    long long slots, int kind, const void* dsa, int dsa_bits,
    const void* fused, int fused_words, int log2_block, int words_per_block,
    const void* C, const void* dollar_map, long long n_dollar,
    const void* pairs, long long n_pairs, int sample_rate,
    const void* read_to_sample, long long num_reads, int S, void* hist,
    void* stream) {
  if (B <= 0 || slots <= 0) return 0;
  if (kind == 0 && (dsa_bits < 1 || dsa_bits > 31)) {
    return cudaErrorInvalidValue;
  }
  if (kind == 1 && !fused_ok(words_per_block, fused_words)) {
    return cudaErrorInvalidValue;
  }
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
  const Walk g = make_walk(dsa, dsa_bits, fused, fused_words, log2_block, C,
                           dollar_map, n_dollar, pairs, n_pairs, sample_rate);
  const int threads = 256;
  const unsigned grid = grid_for(slots, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lp = static_cast<const int32_t*>(l);
  const long long* cp = static_cast<const long long*>(cum);
  const int32_t* r2s = static_cast<const int32_t*>(read_to_sample);
  int32_t* h = static_cast<int32_t*>(hist);
#define RS_HIST(KIND, W)                                                  \
  exact_histogram_kernel<KIND, W><<<grid, threads, 0, st>>>(              \
      lp, cp, B, cap, slots, g, r2s, num_reads, S, h)
  if (kind == 0) {
    RS_HIST(0, 1);
  } else {
    switch (words_per_block) {
      case 1: RS_HIST(1, 1); break;
      case 2: RS_HIST(1, 2); break;
      case 4: RS_HIST(1, 4); break;
      case 8: RS_HIST(1, 8); break;
    }
  }
#undef RS_HIST
  return static_cast<int>(cudaGetLastError());
}
