// Occupancy-bitmap pack and unpack for Hopper (sm_90a).
//
// Pack replaces: src/repro/kernels/pack/pack.py::_pack_kernel, called by
// bitmap_pack_blocked, and fuses the tile reduction that the reference does
// afterwards in jnp (src/repro/quant/wire.py::tile_nnz_from_bitmap and
// tile_mask_from_bitmap). From int8 k (M, N) it writes
//     bitmap (M, N/8) uint8   LSB first: bit j of byte b is element 8b + j
//     nnz    (M/bm, N/bn)     popcount of the tile's bitmap words
//     mask   (M/bm, N/bn)     1 where the tile has any bit set
// The training step does not run it: the NSD kernel writes the same three
// from its registers (csrc/nsd_quant.cu). It serves NSD indices that are
// already at hand (kernels/ops.py::quantized_from_indices).
//
// Bound on the H100: memory (1 byte read per element, 1/8 byte written). The
// design streams k with 16-byte loads: each thread takes 16 consecutive
// bytes of a tile row, and four such loads (bytes 16u of units u, u + 256,
// u + 512, u + 768 of a 128 x 128 tile) are in flight before the first is
// used. Each 4-byte word becomes a 4-bit occupancy with __vcmpne4 and one
// multiply that gathers the bytes' flags, so a thread holds 16 bits; the two
// lanes of a pair hold the two halves of one 32-bit wire word (32 bytes of
// k), which one xor-shuffle joins and the even lane stores. nnz and mask come
// from __popc of the same bits, summed per warp and then in shared memory;
// one block owns one tile, so each has one writer, no atomics, and the result
// is deterministic. (The reference's transposed tiles and sublane rolls exist
// only to get past Mosaic and are not carried over.)
//
// Unpack replaces: src/repro/kernels/pack/pack.py::_unpack_kernel, called by
// bitmap_unpack_blocked: bitmap (M, N/8) uint8 -> mask (M, N) int8 0/1, bit
// j of byte b giving element 8b + j. Bound on the H100: memory (1/8 byte
// read, 1 byte written per element). Elementwise: one thread per bitmap
// byte, whose 8 mask bytes leave in one 8-byte store; neighbouring threads
// read neighbouring bytes and write neighbouring 8-byte words.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kPackLoads = 4;  // 16-byte loads a thread keeps in flight

// 4 occupancy bits of a word of 4 int8: bit j set where byte j is non-zero.
// __vcmpne4 gives 0xff per non-zero byte; masked to 1 << j in byte j, the
// multiply by 0x01010101 sums the four bytes into the top byte.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

__global__ void __launch_bounds__(kThreads)
bitmap_pack_kernel(const int8_t* __restrict__ k, uint32_t* __restrict__ words,
                   int32_t* __restrict__ nnz, int32_t* __restrict__ mask,
                   int N, int bm, int bn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units_per_row = bn / 16;  // even: bn % 32 == 0
  const int units = bm * units_per_row;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * bn;

  int count = 0;
  // units are even in number and a thread's parity is its units', so both
  // lanes of a pair are live or dead together and the shuffle sees both
  for (int base = 0; base < units; base += kThreads * kPackLoads) {
    uint4 v[kPackLoads];
#pragma unroll
    for (int i = 0; i < kPackLoads; ++i) {
      const int u = base + i * kThreads + threadIdx.x;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (u < units)
        v[i] = __ldg(reinterpret_cast<const uint4*>(
            k + (row0 + u / units_per_row) * N + col0 + 16 * (u % units_per_row)));
    }
#pragma unroll
    for (int i = 0; i < kPackLoads; ++i) {
      const int u = base + i * kThreads + threadIdx.x;
      const uint32_t half = nibble(v[i].x) | nibble(v[i].y) << 4 |
                            nibble(v[i].z) << 8 | nibble(v[i].w) << 12;
      count += __popc(half);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, half, 1);
      if ((lane & 1) == 0 && u < units) {
        const size_t off = (row0 + u / units_per_row) * N + col0 + 16 * (u % units_per_row);
        words[off >> 5] = half | other << 16;
      }
    }
  }

  for (int s = 16; s > 0; s >>= 1) count += __shfl_down_sync(0xffffffffu, count, s);
  __shared__ int warp_counts[kWarps];
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_counts[i];
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    nnz[t] = total;
    mask[t] = total > 0;
  }
}

__global__ void __launch_bounds__(kThreads)
bitmap_unpack_kernel(const uint8_t* __restrict__ bitmap, uint2* __restrict__ mask,
                     int nbytes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nbytes) return;
  const uint32_t b = bitmap[i];
  // byte j of the output word pair is bit j of b
  const uint32_t lo = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 |
                      ((b >> 3) & 1u) << 24;
  const uint32_t hi = ((b >> 4) & 1u) | ((b >> 5) & 1u) << 8 | ((b >> 6) & 1u) << 16 |
                      ((b >> 7) & 1u) << 24;
  mask[i] = make_uint2(lo, hi);
}

}  // namespace

// k: (M, N) int8, 16-byte aligned; bitmap: (M, N/8) uint8 written as 32-bit
// words (4-byte aligned, N % 32 == 0); nnz, mask: (M/bm, N/bn) int32.
// M % bm == 0, N % bn == 0, bn % 32 == 0 (checked by the Python wrapper).
extern "C" int bitmap_pack_launch(const int8_t* k, uint8_t* bitmap,
                                  int32_t* nnz, int32_t* mask, int M, int N,
                                  int bm, int bn, cudaStream_t stream) {
  const dim3 grid(N / bn, M / bm);
  bitmap_pack_kernel<<<grid, kThreads, 0, stream>>>(
      k, reinterpret_cast<uint32_t*>(bitmap), nnz, mask, N, bm, bn);
  return static_cast<int>(cudaGetLastError());
}

// bitmap: nbytes uint8; mask: 8 * nbytes int8 (8-byte aligned, checked by
// the Python wrapper).
extern "C" int bitmap_unpack_launch(const uint8_t* bitmap, int8_t* mask,
                                    int nbytes, cudaStream_t stream) {
  const int blocks = (nbytes + kThreads - 1) / kThreads;
  bitmap_unpack_kernel<<<blocks, kThreads, 0, stream>>>(
      bitmap, reinterpret_cast<uint2*>(mask), nbytes);
  return static_cast<int>(cudaGetLastError());
}
