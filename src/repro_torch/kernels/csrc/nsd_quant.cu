// Fused NSD quantizer for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/nsd_quant/nsd_quant.py::_nsd_kernel, called by
// nsd_quantize_blocked. Per (bm, bn) tile of the padded pre-activation
// gradient it writes
//     k   = clip(floor((x + nu) / max(delta, FLT_MIN) + 1/2), -127, 127)  int8
//           (all zeros when delta <= 0)
//     nnz = number of non-zero k in the tile                              int32
//
// Bound on the H100: memory. Each element reads 8 bytes (x and nu, f32) and
// writes 1 byte (k) for a handful of flops, far below the card's ~20 flops
// per byte of f32 balance. The design streams the tile once: 16-byte loads of
// x and nu, 4-byte stores of k, and the tile's nnz from a block reduction in
// shared memory. One block owns one tile, so nnz has one writer: no atomics,
// and the result is deterministic.
//
// Precision: the division is __fdiv_rn (IEEE round to nearest), never a
// multiply by a reciprocal, and every add is __fadd_rn, so nvcc cannot
// contract anything into an FMA. nu arrives as a tensor (u * delta formed by
// the caller, as the reference does), so k agrees bit for bit with
// src/repro/core/nsd.py::nsd_indices for the same (x, nu, delta).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t nsd_level(float x, float nu, float safe,
                                            bool live) {
  float v = floorf(__fadd_rn(__fdiv_rn(__fadd_rn(x, nu), safe), 0.5f));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return live ? static_cast<int8_t>(static_cast<int>(v)) : int8_t(0);
}

__global__ void __launch_bounds__(kThreads)
nsd_quant_kernel(const float* __restrict__ x, const float* __restrict__ nu,
                 const float* __restrict__ delta_p, int8_t* __restrict__ k,
                 int32_t* __restrict__ nnz, int N, int bm, int bn) {
  const float delta = *delta_p;
  const float safe = fmaxf(delta, FLT_MIN);
  const bool live = delta > 0.0f;
  const int vec_per_row = bn / 4;
  const int nvec = bm * vec_per_row;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm;
  const int col0 = blockIdx.x * bn;

  int count = 0;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const size_t off = (row0 + v / vec_per_row) * N + col0 + (v % vec_per_row) * 4;
    const float4 xv = *reinterpret_cast<const float4*>(x + off);
    const float4 nv = *reinterpret_cast<const float4*>(nu + off);
    char4 out;
    out.x = nsd_level(xv.x, nv.x, safe, live);
    out.y = nsd_level(xv.y, nv.y, safe, live);
    out.z = nsd_level(xv.z, nv.z, safe, live);
    out.w = nsd_level(xv.w, nv.w, safe, live);
    *reinterpret_cast<char4*>(k + off) = out;
    count += (out.x != 0) + (out.y != 0) + (out.z != 0) + (out.w != 0);
  }

  for (int s = 16; s > 0; s >>= 1) count += __shfl_down_sync(0xffffffffu, count, s);
  __shared__ int warp_counts[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    nnz[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

}  // namespace

// x, nu: (M, N) f32; delta: one f32 on the device; k: (M, N) int8;
// nnz: (M/bm, N/bn) int32. M % bm == 0, N % bn == 0, bn % 4 == 0, and every
// pointer 16-byte aligned (checked by the Python wrapper).
extern "C" int nsd_quant_launch(const float* x, const float* nu,
                                const float* delta, int8_t* k, int32_t* nnz,
                                int M, int N, int bm, int bn,
                                cudaStream_t stream) {
  const dim3 grid(N / bn, M / bm);
  nsd_quant_kernel<<<grid, kThreads, 0, stream>>>(x, nu, delta, k, nnz, N, bm, bn);
  return static_cast<int>(cudaGetLastError());
}
