// Pieces shared by the two tile-skipping products (bsp_matmul_int8.cu,
// bsp_matmul_dequant.cu): cp.async staging, the split-K cut of the
// contraction, the walk over a split's occupied K-tiles, and the sum of the
// split partials.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace bsp {

constexpr int kTile = 128;  // BM = BN = BK of the mask's tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1 (each byte is staged once).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The K-tiles of one split and which of them the block's row of the mask
// occupies. Split s of S (blockIdx.z of gridDim.z) takes K-tiles
// [s * k_tiles / S, (s + 1) * k_tiles / S): never empty while S <= k_tiles
// (the Python plan, bsp_matmul.py::split_bounds, cuts the same ranges).
// mask is the tile mask of A as stored: (M/128, K/128), or (K/128, M/128)
// when A is stored transposed. Every read is uniform across the block.
struct SplitTiles {
  const int32_t* mask;
  int bi, m_tiles, k_tiles, begin, end;
  bool trans_a;

  __device__ SplitTiles(const int32_t* mask_, int bi_, int M, int K, bool trans_a_)
      : mask(mask_), bi(bi_), m_tiles(M / kTile), k_tiles(K / kTile), trans_a(trans_a_) {
    begin = static_cast<int>(static_cast<long long>(blockIdx.z) * k_tiles / gridDim.z);
    end = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * k_tiles / gridDim.z);
  }
  __device__ bool occupied(int kt) const {
    return (trans_a ? mask[kt * m_tiles + bi] : mask[bi * k_tiles + kt]) != 0;
  }
  // The first occupied K-tile at or after kt, or end.
  __device__ int next(int kt) const {
    while (kt < end && !occupied(kt)) ++kt;
    return kt;
  }
  __device__ int count() const {
    int n = 0;
    for (int kt = begin; kt < end; ++kt) n += occupied(kt);
    return n;
  }
};

// The split-K reduce: blocks of kReduceCols x kReduceRows threads, one
// column of 4 outputs (a vector V) per threadIdx.x. Thread (x, y) adds the
// partials y, y + kReduceRows, y + 2 kReduceRows, ... of its column in that
// order, then row 0 adds the kReduceRows sums in y order: a fixed order, so
// the same bits on every run, with kReduceRows loads in flight per column.
constexpr int kReduceCols = 32, kReduceRows = 8;

// Returns true, with the column's sum in `out`, on the threads that store
// it. partial holds `splits` slices of n4 vectors each.
template <typename V, typename Add>
__device__ __forceinline__ bool sum_partials(const V* __restrict__ partial, int n4,
                                             int splits, Add add, V& out) {
  __shared__ V rows[kReduceRows][kReduceCols];
  const int i = blockIdx.x * kReduceCols + threadIdx.x;
  V s{};
  if (i < n4) {
#pragma unroll 4
    for (int z = threadIdx.y; z < splits; z += kReduceRows)
      s = add(s, partial[static_cast<size_t>(z) * n4 + i]);
  }
  rows[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= n4) return false;
  out = rows[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < kReduceRows; ++y) out = add(out, rows[y][threadIdx.x]);
  return true;
}

inline dim3 reduce_grid(int n4) { return dim3((n4 + kReduceCols - 1) / kReduceCols); }
inline dim3 reduce_block() { return dim3(kReduceCols, kReduceRows); }

}  // namespace bsp
