// Tile-skipping product of int8 NSD indices with an f32 operand, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bsp_matmul/bsp_matmul.py::_bsp_kernel_dequant,
// called by bsp_matmul. Computes
//     C (M, N) f32 = (sum over occupied K-tiles of f32(A[:, tile]) . B[tile, :]) * delta
// with A int8 (the NSD indices k), B f32, f32 accumulation, and mask (per
// 128 x 128 tile of A) naming the occupied K-tiles. A may be read transposed
// (stored (K, M)), so the weight-gradient product dW^T = k^T . x reads k in
// place.
//
// Bound on the H100: f32 operations outside the tensor cores for the large
// layers (2 per multiply-add over the occupied tiles, against 67 TFLOP/s),
// bytes for the thin ones. The reference's f32 product must not run in TF32,
// which would change its numbers, so this is a SIMT kernel: one block of 256
// threads per 128 x 128 tile of C, each thread 8 x 8 outputs in registers.
// The block reads its row of the mask and walks only the occupied K-tiles: a
// masked tile is neither loaded nor multiplied. Each occupied tile is staged
// 16 contraction steps at a time into shared memory, A converted to f32 and
// laid out [k][m] so both operands are read as float4 along the output
// dimension. delta multiplies the accumulator once on exit, as the reference
// does. Simple, not fast: no double buffering, no split-K, so a long
// contraction with few output tiles (dW of the first VGG11 conv) runs on few
// SMs.
//
// Precision: every product of an int8 level and an f32 value is exact in an
// FMA's infinite-precision product; the sums round. The summation order
// differs from the plain version's (per-tile products summed in tile order),
// so the two agree within a band that grows with the contraction length, not
// to the bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;    // BM = BN = BK = the mask's tile
constexpr int kStep = 16;     // contraction steps staged at a time
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each

template <bool kTransA>
__global__ void __launch_bounds__(kThreads)
bsp_dequant_kernel(const int8_t* __restrict__ a, const float* __restrict__ delta_p,
                   const float* __restrict__ b, const int32_t* __restrict__ mask,
                   float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float sa[kStep][kTile];  // [k][m]
  __shared__ __align__(16) float sb[kStep][kTile];  // [k][n]

  const int bi = blockIdx.y;
  const int m0 = bi * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m_tiles = M / kTile, k_tiles = K / kTile;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int occupied = kTransA ? mask[kt * m_tiles + bi] : mask[bi * k_tiles + kt];
    if (!occupied) continue;  // uniform across the block
    for (int ks = 0; ks < kTile; ks += kStep) {
      const int k0 = kt * kTile + ks;
      __syncthreads();  // every thread is done with the previous step
      if (tid < kTile) {
        // A: 128 x 16 int8 = 2048 bytes, 16 bytes per thread
        if (kTransA) {
          // stored (K, M): row k0 + r, 16 consecutive m
          const int r = tid >> 3, cm = (tid & 7) * 16;
          const int4 raw = *reinterpret_cast<const int4*>(
              a + static_cast<size_t>(k0 + r) * M + m0 + cm);
          const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int q = 0; q < 16; q += 4)
            *reinterpret_cast<float4*>(&sa[r][cm + q]) = make_float4(
                static_cast<float>(v[q]), static_cast<float>(v[q + 1]),
                static_cast<float>(v[q + 2]), static_cast<float>(v[q + 3]));
        } else {
          // stored (M, K): row m0 + tid, 16 consecutive k
          const int4 raw = *reinterpret_cast<const int4*>(
              a + static_cast<size_t>(m0 + tid) * K + k0);
          const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int q = 0; q < 16; ++q) sa[q][tid] = static_cast<float>(v[q]);
        }
      }
      // B: 16 x 128 f32 = 512 float4, two per thread
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * kThreads;
        const int r = idx >> 5, cn = (idx & 31) * 4;
        *reinterpret_cast<float4*>(&sb[r][cn]) = *reinterpret_cast<const float4*>(
            b + static_cast<size_t>(k0 + r) * N + n0 + cn);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sb[kk][tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sb[kk][tx * 8 + 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  const float delta = *delta_p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = c + static_cast<size_t>(m0 + ty * 8 + i) * N + n0 + tx * 8;
    *reinterpret_cast<float4*>(row) = make_float4(
        __fmul_rn(acc[i][0], delta), __fmul_rn(acc[i][1], delta),
        __fmul_rn(acc[i][2], delta), __fmul_rn(acc[i][3], delta));
    *reinterpret_cast<float4*>(row + 4) = make_float4(
        __fmul_rn(acc[i][4], delta), __fmul_rn(acc[i][5], delta),
        __fmul_rn(acc[i][6], delta), __fmul_rn(acc[i][7], delta));
  }
}

}  // namespace

// C (M, N) f32 = op(A) . B over the occupied K-tiles, times *delta. op(A) is
// (M, K): A is stored (M, K) int8, or (K, M) when trans_a. B is (K, N) f32.
// mask is the tile mask of A as stored: (M/128, K/128), or (K/128, M/128)
// when trans_a. M, N, K are multiples of 128 and every pointer is 16-byte
// aligned (checked by the Python wrapper).
extern "C" int bsp_matmul_dequant_launch(const int8_t* a, const float* delta,
                                         const float* b, const int32_t* mask,
                                         float* c, int M, int N, int K,
                                         int trans_a, cudaStream_t stream) {
  const dim3 grid(N / kTile, M / kTile);
  if (trans_a) bsp_dequant_kernel<true><<<grid, kThreads, 0, stream>>>(a, delta, b, mask, c, M, N, K);
  else bsp_dequant_kernel<false><<<grid, kThreads, 0, stream>>>(a, delta, b, mask, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
