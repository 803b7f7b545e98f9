// The card's read-rate yardsticks for scripts/torch_rank_ab.py (no kernel
// of the port's paths): how fast independent random reads of 16 or 32
// bytes come back from a buffer when every SM keeps several in flight per
// thread, and how fast the same buffer streams.
//
// rs_probe_random: `reads` reads, `per_thread` of them a thread, their
// addresses a hash of (seed, read number) spread over `units` units of
// `width` bytes (16: one uint4 load; 32: the two uint4 halves of one
// 32-byte sector, issued together).  A thread issues all its loads before
// it uses any (no read depends on another), then writes one word (the
// sum, so the loads are not dropped).  Unlike rs_chase (dependent reads,
// latency) and torch's index_select (one element a thread, its indices
// read from memory), this is the throughput ceiling for rank reads that
// share nothing.
//
// rs_probe_stream: every 16-byte unit of the buffer read once, grid-stride
// (the rate a coalesced pass reaches); with `copy_to`, also written there
// (a read-and-write pass).
//
// Plain C interface, built by the script with nvcc and bound with ctypes;
// runs on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

template <int PER, int WIDTH>
__global__ void __launch_bounds__(256)
    probe_random_kernel(const uint4* __restrict__ buf, long long units,
                        long long reads, unsigned long long seed,
                        uint32_t* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long first = t * PER;
  if (first >= reads) return;
  uint4 v[PER][WIDTH / 16];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const unsigned long long h = mix(seed ^ static_cast<unsigned long long>(
                                                first + k));
    const long long u = static_cast<long long>(
        __umul64hi(h, static_cast<unsigned long long>(units)));
    const uint4* p = buf + u * (WIDTH / 16);
#pragma unroll
    for (int w = 0; w < WIDTH / 16; ++w) {
      v[k][w] = first + k < reads ? __ldg(p + w) : make_uint4(0, 0, 0, 0);
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
#pragma unroll
    for (int w = 0; w < WIDTH / 16; ++w) {
      acc += v[k][w].x ^ v[k][w].y ^ v[k][w].z ^ v[k][w].w;
    }
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(256)
    probe_stream_kernel(const uint4* __restrict__ buf, long long units,
                        uint4* __restrict__ copy_to,
                        uint32_t* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint32_t acc = 0;
  for (long long u = t; u < units; u += step) {
    const uint4 v = __ldcs(buf + u);
    if (copy_to != nullptr) {
      __stcs(copy_to + u, v);
    } else {
      acc += v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (copy_to == nullptr) out[t] = acc;
}

template <int PER, int WIDTH>
cudaError_t launch(const void* buf, long long units, long long reads,
                   unsigned long long seed, void* out, cudaStream_t st) {
  const long long threads = (reads + PER - 1) / PER;
  const long long blocks = (threads + 255) / 256;
  probe_random_kernel<PER, WIDTH><<<static_cast<unsigned>(blocks), 256, 0,
                                    st>>>(
      static_cast<const uint4*>(buf), units, reads, seed,
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// out: uint32 [ceil(reads / per_thread)].  per_thread 1, 2, 4 or 8;
// width 16 or 32; units of `width` bytes in buf.
extern "C" int rs_probe_random(const void* buf, long long units, int width,
                               int per_thread, long long reads,
                               unsigned long long seed, void* out,
                               void* stream) {
  if (reads <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (units <= 0 || reads > (1LL << 34)) return cudaErrorInvalidValue;
#define RS_PROBE(P)                                                       \
  if (per_thread == P) {                                                  \
    return static_cast<int>(                                              \
        width == 16 ? launch<P, 16>(buf, units, reads, seed, out, st)     \
                    : launch<P, 32>(buf, units, reads, seed, out, st));   \
  }
  if (width != 16 && width != 32) return cudaErrorInvalidValue;
  RS_PROBE(1)
  RS_PROBE(2)
  RS_PROBE(4)
  RS_PROBE(8)
#undef RS_PROBE
  return cudaErrorInvalidValue;
}

// out: uint32 [blocks * 256], blocks = 4 a SM (132 SMs: 528).
extern "C" int rs_probe_stream(const void* buf, long long units,
                               void* copy_to, void* out, int blocks,
                               void* stream) {
  if (units <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  probe_stream_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), units, static_cast<uint4*>(copy_to),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
