// Tile-skipping int8 matrix product for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bsp_matmul/bsp_matmul.py::_bsp_kernel_int8,
// called by bsp_matmul_int8. Computes
//     C (M, N) f32 = (sum over occupied K-tiles of A[:, tile] . B[tile, :]) * scale
// with A, B int8, int32 accumulation, and mask (per 128 x 128 tile of A)
// naming the occupied K-tiles. Either operand may be read transposed, so the
// weight-gradient product dW^T = k^T . x_q reads k and x_q in place instead of
// materialising their transposes.
//
// Bound on the H100: int8 tensor-core operations for the large layers (2 ops
// per multiply-add over the occupied tiles only, against 1,979 TOP/s), bytes
// for the thin ones. This first version is simple, not fast: one block per
// 128 x 128 tile of C, 8 warps of mma.sync.m16n8k32 (s8 x s8 -> s32), each warp
// 64 x 32 of C. The block reads its row of the mask and walks only the
// occupied K-tiles: a masked tile is neither staged in shared memory nor
// multiplied, which is what the reference's fetch map buys on the TPU. Tiles
// are staged into shared memory with the contraction contiguous (a 4 x 4 byte
// transpose with __byte_perm for an operand stored the other way), rows
// padded to 144 bytes so the fragment loads of a warp hit 32 distinct banks.
// No wgmma, TMA, double buffering or split-K yet; a product with few output
// tiles and a long contraction (dW of the first VGG11 conv) runs on few SMs.
//
// Exactness: integer sums are exact in any order, so C is bit-identical to
// the plain version's (exact sum, then int32 -> f32, then one f32 multiply).
// Overflow: int32 accumulation holds while K * 127 * 127 < 2^31. At VGG11
// batch 128 the longest contraction is dW of c0 over T = 128 * 32 * 32 =
// 131,072 rows: 127^2 * 131,072 = 2,114,060,288 < 2,147,483,647. At batch 256
// a worst-case input could wrap (as the reference's int32 accumulator would).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;            // BM = BN = BK = the mask's tile
constexpr int kThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kLds = kTile + 16;      // shared row stride in bytes
constexpr int kLdw = kLds / 4;        // ... in 32-bit words (36)

// dst[r][c] = src[(r0 + r) * ld + c0 + c]: rows along the output dimension,
// contraction contiguous. 16-byte copies.
__device__ __forceinline__ void stage_direct(int8_t* dst, const int8_t* __restrict__ src,
                                             int ld, int r0, int c0) {
#pragma unroll
  for (int i = 0; i < kTile * kTile / 16 / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v >> 3, c = (v & 7) * 16;
    const int4 x = *reinterpret_cast<const int4*>(
        src + static_cast<size_t>(r0 + r) * ld + c0 + c);
    *reinterpret_cast<int4*>(dst + r * kLds + c) = x;
  }
}

// dst[r][c] = src[(c0 + c) * ld + r0 + r]: the operand is stored with the
// contraction as its rows. Each thread loads a 4 x 4 byte block (4 rows of
// the contraction, 4 output indices) and transposes it in registers.
__device__ __forceinline__ void stage_transposed(int8_t* dst, const int8_t* __restrict__ src,
                                                 int ld, int r0, int c0) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int i = 0; i < kTile * kTile / 16 / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int kq = (u & 7) + 8 * (u >> 8);  // which 4 contraction rows
    const int rq = (u >> 3) & 31;           // which 4 output indices
    const int8_t* p = src + static_cast<size_t>(c0 + 4 * kq) * ld + r0 + 4 * rq;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + ld);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * static_cast<size_t>(ld));
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * static_cast<size_t>(ld));
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    d[(4 * rq + 0) * kLdw + kq] = __byte_perm(t0, t2, 0x5410);
    d[(4 * rq + 1) * kLdw + kq] = __byte_perm(t0, t2, 0x7632);
    d[(4 * rq + 2) * kLdw + kq] = __byte_perm(t1, t3, 0x5410);
    d[(4 * rq + 3) * kLdw + kq] = __byte_perm(t1, t3, 0x7632);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kThreads)
bsp_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const float* __restrict__ scale_p, const int32_t* __restrict__ mask,
                float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) int8_t sa[kTile * kLds];
  __shared__ __align__(16) int8_t sb[kTile * kLds];
  const uint32_t* saw = reinterpret_cast<const uint32_t*>(sa);
  const uint32_t* sbw = reinterpret_cast<const uint32_t*>(sb);

  const int bi = blockIdx.y;
  const int m0 = bi * kTile, n0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m_tiles = M / kTile, k_tiles = K / kTile;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int occupied = kTransA ? mask[kt * m_tiles + bi] : mask[bi * k_tiles + kt];
    if (!occupied) continue;  // uniform across the block
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    if (kTransA) stage_transposed(sa, a, M, m0, k0); else stage_direct(sa, a, K, m0, k0);
    if (kTransB) stage_direct(sb, b, K, n0, k0); else stage_transposed(sb, b, N, n0, k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTile / 32; ++ks) {
      const int kw = ks * 8;  // 32 int8 = 8 words per mma step
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = saw[r * kLdw + kw + t];
        af[mi][1] = saw[(r + 8) * kLdw + kw + t];
        af[mi][2] = saw[r * kLdw + kw + 4 + t];
        af[mi][3] = saw[(r + 8) * kLdw + kw + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = sbw[n * kLdw + kw + t];
        bf[ni][1] = sbw[n * kLdw + kw + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  const float scale = *scale_p;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const size_t r = m0 + wm + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      const int* v = acc[mi][ni];
      *reinterpret_cast<float2*>(c + r * N + col) = make_float2(
          __fmul_rn(__int2float_rn(v[0]), scale), __fmul_rn(__int2float_rn(v[1]), scale));
      *reinterpret_cast<float2*>(c + (r + 8) * N + col) = make_float2(
          __fmul_rn(__int2float_rn(v[2]), scale), __fmul_rn(__int2float_rn(v[3]), scale));
    }
  }
}

}  // namespace

// C (M, N) f32 = op(A) . op(B) over the occupied K-tiles, times *scale.
// op(A) is (M, K): A is stored (M, K), or (K, M) when trans_a. op(B) is
// (K, N): B is stored (K, N), or (N, K) when trans_b. mask is the tile mask
// of A as stored: (M/128, K/128), or (K/128, M/128) when trans_a. M, N, K are
// multiples of 128 and every pointer is 16-byte aligned (checked by the
// Python wrapper).
extern "C" int bsp_matmul_int8_launch(const int8_t* a, const int8_t* b,
                                      const float* scale, const int32_t* mask,
                                      float* c, int M, int N, int K,
                                      int trans_a, int trans_b,
                                      cudaStream_t stream) {
  const dim3 grid(N / kTile, M / kTile);
  if (trans_a) {
    if (trans_b) bsp_int8_kernel<true, true><<<grid, kThreads, 0, stream>>>(a, b, scale, mask, c, M, N, K);
    else bsp_int8_kernel<true, false><<<grid, kThreads, 0, stream>>>(a, b, scale, mask, c, M, N, K);
  } else {
    if (trans_b) bsp_int8_kernel<false, true><<<grid, kThreads, 0, stream>>>(a, b, scale, mask, c, M, N, K);
    else bsp_int8_kernel<false, false><<<grid, kThreads, 0, stream>>>(a, b, scale, mask, c, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
