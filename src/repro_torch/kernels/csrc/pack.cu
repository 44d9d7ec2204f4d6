// Occupancy-bitmap pack for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack/pack.py::_pack_kernel, called by
// bitmap_pack_blocked, and fuses the tile reduction that the reference does
// afterwards in jnp (src/repro/quant/wire.py::tile_nnz_from_bitmap and
// tile_mask_from_bitmap). From int8 k (M, N) it writes
//     bitmap (M, N/8) uint8   LSB first: bit j of byte b is element 8b + j
//     nnz    (M/bm, N/bn)     popcount of the tile's bitmap words
//     mask   (M/bm, N/bn)     1 where the tile has any bit set
//
// Bound on the H100: memory (1 byte read per element, 1/8 byte written).
// The design needs no layout trick: one __ballot_sync over 32 consecutive
// elements of a row yields one 32-bit word whose little-endian bytes are
// exactly the wire bytes, so lane 0 stores it as is. nnz and mask come from
// __popc of the same words, summed per warp and then in shared memory; one
// block owns one tile, so there are no atomics and the result is
// deterministic. (The reference's transposed tiles and sublane rolls exist
// only to get past Mosaic and are not carried over.)
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bitmap_pack_kernel(const int8_t* __restrict__ k, uint32_t* __restrict__ words,
                   int32_t* __restrict__ nnz, int32_t* __restrict__ mask,
                   int N, int bm, int bn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_words_per_row = bn / 32;
  const int tile_words = bm * tile_words_per_row;
  const int row_words = N / 32;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm;
  const int word0 = blockIdx.x * tile_words_per_row;

  int count = 0;
  // w depends only on the warp, so every lane of a warp takes part in each ballot
  for (int w = warp; w < tile_words; w += kWarps) {
    const size_t r = row0 + w / tile_words_per_row;
    const int wc = word0 + w % tile_words_per_row;
    const int8_t v = k[r * N + static_cast<size_t>(wc) * 32 + lane];
    const uint32_t bits = __ballot_sync(0xffffffffu, v != 0);
    if (lane == 0) {
      words[r * row_words + wc] = bits;
      count += __popc(bits);
    }
  }

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

}  // namespace

// k: (M, N) int8; bitmap: (M, N/8) uint8 written as 32-bit words (4-byte
// aligned, N % 32 == 0); nnz, mask: (M/bm, N/bn) int32. M % bm == 0,
// N % bn == 0, bn % 32 == 0 (checked by the Python wrapper).
extern "C" int bitmap_pack_launch(const int8_t* k, uint8_t* bitmap,
                                  int32_t* nnz, int32_t* mask, int M, int N,
                                  int bm, int bn, cudaStream_t stream) {
  const dim3 grid(N / bn, M / bm);
  bitmap_pack_kernel<<<grid, kThreads, 0, stream>>>(
      k, reinterpret_cast<uint32_t*>(bitmap), nnz, mask, N, bm, bn);
  return static_cast<int>(cudaGetLastError());
}
