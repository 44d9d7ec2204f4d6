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
// Bound on the H100: the tensor cores' TF32 rate (495 TFLOP/s) at two TF32
// products per multiply-add (below), or bytes for the thin products. The
// weight-gradient products of the first convolutions are tall and thin (c0
// at batch 128: one 128 x 128 output tile over 1,024 K-tiles), so one block
// per output tile would leave most of the 132 SMs idle.
//
// Design:
// - Tensor cores without changing the f32 numbers beyond the f32 band. Plain
//   TF32 (11 significant bits) would. But k holds integers with |k| <= 127,
//   which TF32 holds exactly, so only B is split: B = B_hi + B_lo + r with
//   B_hi = tf32(B) and B_lo = tf32(B - B_hi), both rounded to nearest, ties
//   away (the bit arithmetic of cvt.rna.tf32.f32), |r| <= 2^-22 |B|. Each
//   K-step runs mma.sync.m16n8k8 (tf32 x tf32 -> f32) on B_lo, then on B_hi,
//   into one f32 accumulator. The products k * B_hi and k * B_lo are exact
//   (7 x 11 bits), so what is lost is r (relative 2^-22 per element, random
//   sign) and the accumulation's rounding. Not wgmma: wgmma reads TF32
//   operands K-major only, and B is stored with N contiguous; the split is
//   made in registers, where the fragments are loaded.
// - Split-K, as bsp_matmul_int8.cu: grid (N/128, M/128, S), block z walks
//   the occupied K-tiles of the z-th of S K-ranges; S = 1 when the output
//   tiles fill the card. With S > 1 each block writes its f32 partial and a
//   second kernel, launched here, adds the S partials in a fixed order
//   (bsp::sum_partials; never with atomics: the result is the same from run
//   to run), then multiplies by delta once.
// - A ring of kStages chunks of 32 contraction steps in dynamic shared
//   memory (94 KB, two blocks an SM), filled with cp.async: the next chunks'
//   loads are in flight while the tensor cores multiply the current one. A
//   masked K-tile's four chunks are neither loaded nor multiplied. A is staged
//   as int8 in its stored layout (rows padded so fragment loads are free of
//   bank conflicts either way) and widened to f32 at the fragment load; B
//   rows are padded by 8 floats for the same reason.
//
// Precision: the sum order differs from the plain version's (per-tile
// products summed in tile order), and the tensor core rounds its own sums,
// so the two agree within a band that grows with the contraction length
// (8 sqrt(K) 2^-24 relative L2, chip_smoke.py), not to the bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "bsp_split.cuh"

namespace {

using bsp::kTile;
constexpr int kChunk = 32;     // contraction steps per ring stage
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 of C each
constexpr int kStages = 4;
constexpr int kLdaRows = 48;   // A stored (M, K): 128 rows of 32 bytes, padded
constexpr int kLdaCols = 144;  // A stored (K, M): 32 rows of 128 bytes, padded
constexpr int kLdb = 136;      // B: 32 rows of 128 floats, padded
constexpr int kABytes = kTile * kLdaRows;  // >= kChunk * kLdaCols
constexpr int kBBytes = kChunk * kLdb * 4;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 94,208

// One chunk of A (128 x 32 int8) and B (32 x 128 f32) into a ring stage.
template <bool kTransA>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const int8_t* __restrict__ a,
                                           const float* __restrict__ b, int M, int N, int K,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  const uint32_t sa = bsp::smem_u32(stage), sb = sa + kABytes;
  if (kTransA) {  // row k0 + k, 16 bytes of m
    const int k = tid >> 3, cm = (tid & 7) * 16;
    bsp::cp_async16(sa + k * kLdaCols + cm, a + static_cast<size_t>(k0 + k) * M + m0 + cm);
  } else {  // row m0 + m, 16 bytes of k
    const int m = tid >> 1, ck = (tid & 1) * 16;
    bsp::cp_async16(sa + m * kLdaRows + ck, a + static_cast<size_t>(m0 + m) * K + k0 + ck);
  }
#pragma unroll
  for (int i = 0; i < kChunk * kTile / 4 / kThreads; ++i) {
    const int v = tid + i * kThreads;
    const int k = v >> 5, cn = (v & 31) * 4;
    bsp::cp_async16(sb + (k * kLdb + cn) * 4, b + static_cast<size_t>(k0 + k) * N + n0 + cn);
  }
}

// An int8 level (sign-extended) as the bits of the exact f32 (and TF32)
// value: 1.5 * 2^23 + v, less 1.5 * 2^23, on the fast integer and FP pipes.
__device__ __forceinline__ uint32_t level_bits(int v) {
  return __float_as_uint(__fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f));
}

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties away.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(  // registers only: the compiler may schedule it
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kTransA>
__global__ void __launch_bounds__(kThreads)
bsp_dequant_kernel(const int8_t* __restrict__ a, const float* __restrict__ delta_p,
                   const float* __restrict__ b, const int32_t* __restrict__ mask,
                   float* __restrict__ c, float* __restrict__ partial, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bi = blockIdx.y;
  const int m0 = bi * kTile, n0 = blockIdx.x * kTile;
  const bsp::SplitTiles tiles(mask, bi, M, K, kTransA);
  const int n_chunks = tiles.count() * (kTile / kChunk);

  int load_kt = tiles.next(tiles.begin), load_sub = 0;
  auto issue = [&](int slot) {  // the next chunk of an occupied tile
    if (load_kt < tiles.end) {
      load_chunk<kTransA>(smem + slot * kStageBytes, a, b, M, N, K, m0, n0,
                          load_kt * kTile + load_sub * kChunk);
      if (++load_sub == kTile / kChunk) {
        load_sub = 0;
        load_kt = tiles.next(load_kt + 1);
      }
    }
    bsp::cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int i = 0; i < n_chunks; ++i) {
    bsp::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i landed for everyone; chunk i-1's slot is free
    issue((i + kStages - 1) % kStages);
    const uint8_t* stage = smem + (i % kStages) * kStageBytes;
    const int8_t* sa = reinterpret_cast<const int8_t*>(stage);
    const float* sb = reinterpret_cast<const float*>(stage + kABytes);
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      // A (16 x 8, row): (g, t), (g+8, t), (g, t+4), (g+8, t+4) of each m16
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = r + (e & 1) * 8, k = kk + t + (e >> 1) * 4;
          af[mi][e] = level_bits(kTransA ? sa[k * kLdaCols + m] : sa[m * kLdaRows + k]);
        }
      }
      // B (8 x 8, col): (k = t, n = g), (k = t+4, n = g) of each n8, split
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sb[(kk + t + e * 4) * kLdb + n];
          bh[ni][e] = tf32_rna(x);
          bl[ni][e] = tf32_rna(__fsub_rn(x, __uint_as_float(bh[ni][e])));
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], af[mi], bl[ni][0], bl[ni][1]);
          mma_tf32(acc[mi][ni], af[mi], bh[ni][0], bh[ni][1]);
        }
    }
  }
  bsp::cp_async_wait<0>();  // no copy may outlive the block

  // acc[mi][ni]: rows g, g+8 and columns 2t, 2t+1 of each 16 x 8 block.
  // A split's partial goes out unscaled (times 1, exact); delta waits for
  // the reduce.
  const bool whole = gridDim.z == 1;
  const float delta = whole ? *delta_p : 1.0f;
  float* out = whole ? c : partial + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const size_t r = m0 + wm + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      const float* v = acc[mi][ni];
      *reinterpret_cast<float2*>(out + r * N + col) =
          make_float2(__fmul_rn(v[0], delta), __fmul_rn(v[1], delta));
      *reinterpret_cast<float2*>(out + (r + 8) * N + col) =
          make_float2(__fmul_rn(v[2], delta), __fmul_rn(v[3], delta));
    }
  }
}

// C = (the `splits` f32 partials, added in bsp::sum_partials' fixed order)
// * delta.
__global__ void bsp_dequant_kernel_reduce(const float* __restrict__ partial,
                                          const float* __restrict__ delta_p,
                                          float* __restrict__ c, int n4, int splits) {
  float4 s;
  const auto add = [](float4 x, float4 y) {
    return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z),
                       __fadd_rn(x.w, y.w));
  };
  if (!bsp::sum_partials(reinterpret_cast<const float4*>(partial), n4, splits, add, s)) return;
  const float delta = *delta_p;
  reinterpret_cast<float4*>(c)[blockIdx.x * bsp::kReduceCols + threadIdx.x] =
      make_float4(__fmul_rn(s.x, delta), __fmul_rn(s.y, delta), __fmul_rn(s.z, delta),
                  __fmul_rn(s.w, delta));
}

template <bool kTransA>
cudaError_t launch(const int8_t* a, const float* delta, const float* b, const int32_t* mask,
                   float* c, float* partial, int M, int N, int K, int splits,
                   cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      bsp_dequant_kernel<kTransA>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (opted != cudaSuccess) return opted;
  bsp_dequant_kernel<kTransA><<<dim3(N / kTile, M / kTile, splits), kThreads, kSmemBytes,
                                stream>>>(a, delta, b, mask, c, partial, M, N, K);
  return cudaSuccess;
}

}  // namespace

// C (M, N) f32 = op(A) . B over the occupied K-tiles, times *delta. op(A) is
// (M, K): A is stored (M, K) int8, or (K, M) when trans_a. B is (K, N) f32.
// mask is the tile mask of A as stored: (M/128, K/128), or (K/128, M/128)
// when trans_a. M, N, K are multiples of 128 and every pointer is 16-byte
// aligned (checked by the Python wrapper). splits >= 1 cuts the contraction
// into that many K-ranges; with splits > 1, partial is an f32 workspace of
// splits * M * N elements (unused, and may be null, when splits == 1).
extern "C" int bsp_matmul_dequant_launch(const int8_t* a, const float* delta,
                                         const float* b, const int32_t* mask,
                                         float* c, float* partial, int M, int N, int K,
                                         int trans_a, int splits, cudaStream_t stream) {
  const cudaError_t err =
      trans_a ? launch<true>(a, delta, b, mask, c, partial, M, N, K, splits, stream)
              : launch<false>(a, delta, b, mask, c, partial, M, N, K, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int n4 = M / 4 * N;
    bsp_dequant_kernel_reduce<<<bsp::reduce_grid(n4), bsp::reduce_block(), 0, stream>>>(
        partial, delta, c, n4, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
