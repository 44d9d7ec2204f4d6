// Chunk-local levels compact and expand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/levels/levels.py::_compact_kernel, called by
// levels_compact_blocked, and ::_expand_kernel, called by
// levels_expand_blocked. Per 256-element chunk (one row of a (C, 256) int8
// array):
//     compact  out[:count] = the chunk's non-zeros in order, out[count:] = 0,
//              counts[c] = count
//     expand   out[j] = mask[j] ? lv[P[j]] : 0, P[j] = occupied positions < j
//
// Bound on the H100: memory. Each byte is read once and written once (expand
// reads two), a few integer operations per byte. The design: one warp per
// chunk, 8 consecutive bytes per lane (one 8-byte load), and a warp
// exclusive scan of the lanes' non-zero counts (__shfl_up_sync), which gives
// each lane the stable slot of its first non-zero. Compact scatters the
// lane's non-zeros into the warp's zeroed 256-byte buffer in shared memory
// and writes the buffer back with 8-byte stores; expand stages the chunk's
// levels in the buffer and gathers each lane's 8 outputs from it. The
// reference's (256, C) transposed layout and butterfly network exist only for
// Mosaic's sublane rolls and are not carried over. Integer work: the results
// are bit-identical to the plain versions'.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = kChunk / 32;  // 8 consecutive bytes per lane

// Exclusive prefix sum of v over the warp's lanes; total gets the warp's sum.
__device__ __forceinline__ int warp_exclusive_scan(int v, int lane, int& total) {
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - v;
}

__device__ __forceinline__ uint32_t byte_of(const uint2& v, int j) {
  return ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
levels_compact_kernel(const int8_t* __restrict__ k, int8_t* __restrict__ out,
                      int32_t* __restrict__ counts, int C) {
  __shared__ __align__(8) uint8_t buf[kWarps][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;  // uniform across the warp
  const size_t off = static_cast<size_t>(c) * kChunk + lane * kPerLane;
  const uint2 v = *reinterpret_cast<const uint2*>(k + off);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) n += byte_of(v, j) != 0;
  int total;
  int slot = warp_exclusive_scan(n, lane, total);

  uint8_t* b = buf[warp];
  *reinterpret_cast<uint2*>(b + lane * kPerLane) = make_uint2(0u, 0u);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const uint32_t x = byte_of(v, j);
    if (x) b[slot++] = static_cast<uint8_t>(x);
  }
  __syncwarp();
  *reinterpret_cast<uint2*>(out + off) =
      *reinterpret_cast<const uint2*>(b + lane * kPerLane);
  if (lane == 0) counts[c] = total;
}

__global__ void __launch_bounds__(kThreads)
levels_expand_kernel(const int8_t* __restrict__ lv, const int8_t* __restrict__ mask,
                     int8_t* __restrict__ out, int C) {
  __shared__ __align__(8) uint8_t buf[kWarps][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;  // uniform across the warp
  const size_t off = static_cast<size_t>(c) * kChunk + lane * kPerLane;
  const uint2 m = *reinterpret_cast<const uint2*>(mask + off);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) n += byte_of(m, j) != 0;
  int total;
  int slot = warp_exclusive_scan(n, lane, total);

  uint8_t* b = buf[warp];
  *reinterpret_cast<uint2*>(b + lane * kPerLane) =
      *reinterpret_cast<const uint2*>(lv + off);
  __syncwarp();
  uint32_t o[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (byte_of(m, j)) o[j >> 2] |= static_cast<uint32_t>(b[slot++]) << (8 * (j & 3));
  }
  *reinterpret_cast<uint2*>(out + off) = make_uint2(o[0], o[1]);
}

}  // namespace

// k, out: (C, 256) int8; counts: (C,) int32. Pointers 16-byte aligned
// (checked by the Python wrapper).
extern "C" int levels_compact_launch(const int8_t* k, int8_t* out,
                                     int32_t* counts, int C,
                                     cudaStream_t stream) {
  const int blocks = (C + kWarps - 1) / kWarps;
  levels_compact_kernel<<<blocks, kThreads, 0, stream>>>(k, out, counts, C);
  return static_cast<int>(cudaGetLastError());
}

// lv, mask, out: (C, 256) int8; mask non-zero = occupied. Pointers 16-byte
// aligned (checked by the Python wrapper).
extern "C" int levels_expand_launch(const int8_t* lv, const int8_t* mask,
                                    int8_t* out, int C, cudaStream_t stream) {
  const int blocks = (C + kWarps - 1) / kWarps;
  levels_expand_kernel<<<blocks, kThreads, 0, stream>>>(lv, mask, out, C);
  return static_cast<int>(cudaGetLastError());
}
