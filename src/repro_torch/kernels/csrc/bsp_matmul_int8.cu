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
// for the thin ones. The weight-gradient products of the first convolutions
// are tall and thin (c0 at batch 128: one 128 x 128 output tile over 1,024
// K-tiles), so one block per output tile would leave most of the 132 SMs idle.
//
// Design:
// - Split-K. The grid is (N/128, M/128, S): block z walks the occupied
//   K-tiles of the z-th of S contiguous K-ranges (bsp_split.cuh). The wrapper
//   picks S from the shapes alone (bsp_matmul.py::split_k): S = 1 when the
//   output tiles fill the card. With S > 1 each block writes its int32
//   partial sums to the wrapper's workspace and a second kernel, launched
//   here, adds the S partials (bsp::sum_partials), converts and scales.
// - A ring of kStages K-tiles in dynamic shared memory, filled with cp.async:
//   the loads of the next occupied tiles are in flight while the tensor cores
//   multiply the current one. A masked tile is neither loaded nor multiplied.
// - wgmma.m64n128k32 (s8 x s8 -> s32), two warpgroups each 64 rows x 128
//   columns of C, both operands read from shared memory in the K-major,
//   128-byte-swizzled layout (one 128-byte row per output index, so a
//   K-tile is one swizzle row). An operand stored with the contraction
//   contiguous (A of dx, B = w_q read transposed) is copied by cp.async
//   straight into that layout. An operand stored with the contraction as its
//   rows (k and x_q of dW) cannot be: wgmma reads 8-bit operands K-major
//   only, and neither TMA nor ldmatrix transposes bytes. It is staged raw by
//   cp.async and transposed into the K-major buffer with a 4 x 4 __byte_perm
//   register transpose, bank-conflict-free on both sides.
//
// Exactness: integer sums are exact in any order, and int32 two's-complement
// addition is associative with wrap-around, so the split partials add (in any
// order) to the bits of the unsplit accumulator. C is bit-identical to the
// plain version's (exact sum, then int32 -> f32, then one f32 multiply).
// Overflow: int32 accumulation holds while K * 127 * 127 < 2^31. At VGG11
// batch 128 the longest contraction is dW of c0 over T = 128 * 32 * 32 =
// 131,072 rows: 127^2 * 131,072 = 2,114,060,288 < 2,147,483,647. At batch 256
// a worst-case input could wrap (as the reference's int32 accumulator would).
#include <cuda_runtime.h>
#include <cstdint>

#include "bsp_split.cuh"

namespace {

using bsp::kTile;
constexpr int kTileBytes = kTile * kTile;  // one int8 tile, 16 KB
constexpr int kThreads = 256;              // two warpgroups
constexpr int kStages = 4;                 // K-tiles in the ring

// Dynamic shared memory: the ring (A and B tile per stage), a K-major tile for
// each operand stored with the contraction as rows, and slack to align the
// swizzled tiles to 1,024 bytes.
template <bool kRawA, bool kRawB>
constexpr int smem_bytes() {
  return (2 * kStages + kRawA + kRawB) * kTileBytes + 1024;
}

// Stage one 128 x 128 int8 tile with cp.async, 16 bytes a copy.
// kKRows = false: src rows are the output index, the contraction contiguous;
//   row r's 16-byte chunk c lands at r * 128 + 16 * (c ^ (r & 7)): the
//   128-byte swizzle wgmma reads.
// kKRows = true: src rows are the contraction; row k's chunk c lands at
//   k * 128 + 16 * (c ^ ((k >> 2) & 7)), the layout transpose_tile reads
//   without bank conflicts.
template <bool kKRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const int8_t* __restrict__ src,
                                          int ld, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < kTileBytes / 16 / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int row = v >> 3, c = v & 7;
    if (kKRows)
      bsp::cp_async16(dst + row * kTile + ((c ^ ((row >> 2) & 7)) << 4),
                      src + static_cast<size_t>(k0 + row) * ld + r0 + 16 * c);
    else
      bsp::cp_async16(dst + row * kTile + ((c ^ (row & 7)) << 4),
                      src + static_cast<size_t>(r0 + row) * ld + k0 + 16 * c);
  }
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&o)[4], int i) {
  return i == 0 ? o[0] : i == 1 ? o[1] : i == 2 ? o[2] : o[3];
}

// raw (a tile staged with kKRows) -> dst in the K-major swizzled layout.
// Each thread moves 4 blocks of 4 contraction rows x 4 output indices. Lane
// bits: 2 for the output quad, 3 for the contraction quad, so a warp's reads
// (chunk rq/4 ^ kq&7) and its rotated writes (chunk kq/4 ^ row&7) each hit
// 32 distinct banks.
__device__ __forceinline__ void transpose_tile(uint8_t* __restrict__ dst,
                                               const uint8_t* __restrict__ raw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rq_lo = lane & 3, kq_lo = lane >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int blk = warp * 4 + i;
    const int rq = (blk & 7) * 4 + rq_lo;   // output indices 4rq .. 4rq+3
    const int kq = (blk >> 3) * 8 + kq_lo;  // contraction rows 4kq .. 4kq+3
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(
          raw + (4 * kq + j) * kTile + (((rq >> 2) ^ (kq & 7)) << 4) + ((rq & 3) << 2));
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    // o[q]: the 4 contraction values of output index 4rq + q, in k order
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = (s + rq_lo) & 3;
      const int row = 4 * rq + q;
      *reinterpret_cast<uint32_t*>(dst + row * kTile + (((kq >> 2) ^ (row & 7)) << 4) +
                                   ((kq & 3) << 2)) = pick(o, q);
    }
  }
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// 8-row groups 1,024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32, this warpgroup's) += A (64 x 32 s8) . B (32 x 128 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kThreads, 1)
bsp_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const float* __restrict__ scale_p, const int32_t* __restrict__ mask,
                float* __restrict__ c, int32_t* __restrict__ partial, int M, int N, int K) {
  constexpr bool kRawA = kTransA;   // A stored (K, M): contraction as rows
  constexpr bool kRawB = !kTransB;  // B stored (K, N): likewise
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (bsp::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kmajor_a = smem + 2 * kStages * kTileBytes;
  uint8_t* kmajor_b = kmajor_a + (kRawA ? kTileBytes : 0);

  const int bi = blockIdx.y;
  const int m0 = bi * kTile, n0 = blockIdx.x * kTile;
  const bsp::SplitTiles tiles(mask, bi, M, K, kTransA);
  const int n_occupied = tiles.count();

  int load_kt = tiles.next(tiles.begin);
  auto issue = [&](int slot) {  // the next occupied tile into ring slot `slot`
    if (load_kt < tiles.end) {
      const int k0 = load_kt * kTile;
      const uint32_t sa = bsp::smem_u32(smem + slot * 2 * kTileBytes), sb = sa + kTileBytes;
      if (kTransA) load_tile<true>(sa, a, M, m0, k0); else load_tile<false>(sa, a, K, m0, k0);
      if (kTransB) load_tile<false>(sb, b, K, n0, k0); else load_tile<true>(sb, b, N, n0, k0);
      load_kt = tiles.next(load_kt + 1);
    }
    bsp::cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const int wg = threadIdx.x >> 7;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int i = 0; i < n_occupied; ++i) {
    bsp::cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... everyone's; and every warpgroup is done with tile i-1
    issue((i + kStages - 1) % kStages);  // the slot tile i-1 used
    uint8_t* ta = smem + (i % kStages) * 2 * kTileBytes;
    uint8_t* tb = ta + kTileBytes;
    if (kRawA || kRawB) {
      if (kRawA) { transpose_tile(kmajor_a, ta); ta = kmajor_a; }
      if (kRawB) { transpose_tile(kmajor_b, tb); tb = kmajor_b; }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const uint64_t da = sw128_desc(bsp::smem_u32(ta + wg * 64 * kTile));
    const uint64_t db = sw128_desc(bsp::smem_u32(tb));
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kTile / 32; ++ks)  // 32 bytes of K = 2 descriptor units
      wgmma_s8(acc, da + 2 * ks, db + 2 * ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
  }
  bsp::cp_async_wait<0>();  // no copy may outlive the block

  // acc[4j + e]: row g (+8 for e >= 2), column 8j + 2t (+1 for odd e) of the
  // warp's 16 x 128 slice of C
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t r = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
  if (gridDim.z == 1) {
    const float scale = *scale_p;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(c + r * N + col) =
          make_float2(__fmul_rn(__int2float_rn(acc[4 * j]), scale),
                      __fmul_rn(__int2float_rn(acc[4 * j + 1]), scale));
      *reinterpret_cast<float2*>(c + (r + 8) * N + col) =
          make_float2(__fmul_rn(__int2float_rn(acc[4 * j + 2]), scale),
                      __fmul_rn(__int2float_rn(acc[4 * j + 3]), scale));
    }
  } else {
    int32_t* p = partial + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<int2*>(p + r * N + col) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(p + (r + 8) * N + col) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// C = f32(sum of the `splits` int32 partials) * scale. Unsigned adds: the
// wrap-around of two's complement, without signed overflow; any order gives
// the same bits.
__global__ void bsp_int8_kernel_reduce(const int32_t* __restrict__ partial,
                                       const float* __restrict__ scale_p,
                                       float* __restrict__ c, int n4, int splits) {
  uint4 s;
  const auto add = [](uint4 x, uint4 y) {
    return make_uint4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  };
  if (!bsp::sum_partials(reinterpret_cast<const uint4*>(partial), n4, splits, add, s)) return;
  const float scale = *scale_p;
  reinterpret_cast<float4*>(c)[blockIdx.x * bsp::kReduceCols + threadIdx.x] = make_float4(
      __fmul_rn(__int2float_rn(static_cast<int>(s.x)), scale),
      __fmul_rn(__int2float_rn(static_cast<int>(s.y)), scale),
      __fmul_rn(__int2float_rn(static_cast<int>(s.z)), scale),
      __fmul_rn(__int2float_rn(static_cast<int>(s.w)), scale));
}

template <bool kTransA, bool kTransB>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* scale, const int32_t* mask,
                   float* c, int32_t* partial, int M, int N, int K, int splits,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<kTransA, !kTransB>();
  static const cudaError_t opted = cudaFuncSetAttribute(
      bsp_int8_kernel<kTransA, kTransB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return opted;
  bsp_int8_kernel<kTransA, kTransB><<<dim3(N / kTile, M / kTile, splits), kThreads, bytes,
                                      stream>>>(a, b, scale, mask, c, partial, M, N, K);
  return cudaSuccess;
}

}  // namespace

// C (M, N) f32 = op(A) . op(B) over the occupied K-tiles, times *scale.
// op(A) is (M, K): A is stored (M, K), or (K, M) when trans_a. op(B) is
// (K, N): B is stored (K, N), or (N, K) when trans_b. mask is the tile mask
// of A as stored: (M/128, K/128), or (K/128, M/128) when trans_a. M, N, K are
// multiples of 128 and every pointer is 16-byte aligned (checked by the
// Python wrapper). splits >= 1 cuts the contraction into that many K-ranges;
// with splits > 1, partial is an int32 workspace of splits * M * N elements
// (unused, and may be null, when splits == 1).
extern "C" int bsp_matmul_int8_launch(const int8_t* a, const int8_t* b,
                                      const float* scale, const int32_t* mask,
                                      float* c, int32_t* partial, int M, int N, int K,
                                      int trans_a, int trans_b, int splits,
                                      cudaStream_t stream) {
  cudaError_t err;
  if (trans_a)
    err = trans_b ? launch<true, true>(a, b, scale, mask, c, partial, M, N, K, splits, stream)
                  : launch<true, false>(a, b, scale, mask, c, partial, M, N, K, splits, stream);
  else
    err = trans_b ? launch<false, true>(a, b, scale, mask, c, partial, M, N, K, splits, stream)
                  : launch<false, false>(a, b, scale, mask, c, partial, M, N, K, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int n4 = M / 4 * N;
    bsp_int8_kernel_reduce<<<bsp::reduce_grid(n4), bsp::reduce_block(), 0, stream>>>(
        partial, scale, c, n4, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
