// Fused NSD quantizer for Hopper (sm_90a): dither draw, quantizer, occupancy
// bitmap and tile mask in one launch.
//
// Replaces: src/repro/kernels/nsd_quant/nsd_quant.py::_nsd_kernel, called by
// nsd_quantize_blocked, fused with what the reference runs after it on the
// main path: the occupancy pack (src/repro/kernels/pack/pack.py::
// _pack_kernel) and the tile reduction (src/repro/quant/wire.py::
// tile_mask_from_bitmap). It reads x (rows, cols) f32 as it stands, row-major
// and unpadded (the first `count` elements of the flat order are live), and
// writes over the 128-padded (Tp, Np):
//     k      = clip(floor((x + nu) / max(delta, FLT_MIN) + 1/2), -127, 127)
//              int8; all zeros when delta <= 0; 0 in the padding, where x is
//              never read
//     bitmap (Tp, Np/8) uint8, LSB first: bit j of byte b is element 8b + j
//              (optional: a null pointer skips it)
//     nnz    (Tp/128, Np/128) int32, non-zero count of each 128 x 128 tile
//     mask   (Tp/128, Np/128) int32, nnz > 0
//
// The dither nu comes fed (a tensor of x's shape) or is drawn here from a
// 64-bit stream key with Philox4x32-10 (Random123's and cuRAND's generator):
//     key     = (seed & 0xffffffff, seed >> 32)
//     counter = (c / 4, r, 0, 0) for element (r, c) of the (rows, cols) view
//     u       = (word[c % 4] >> 8) * 2^-24 - 1/2     exact in f32, [-1/2, 1/2)
//     nu      = __fmul_rn(u, delta)
// philox_uniform_kernel below writes u alone from the same formula, and
// src/repro_torch/kernels/nsd_quant.py::philox_uniform_plain repeats it in
// torch integer arithmetic.
//
// Bound on the H100: memory. Per live element 4 bytes of x are read (8 with
// fed noise) and per padded element 1 + 1/8 bytes are written. The integer
// and float work (tens of instructions an element: Philox, an IEEE
// division) is close behind, and its dependent chains, not the bytes, set
// the time of the large layers (PERF.md section 6), so lanes are spent only
// on live columns.
// The design: a 128 x 128 tile belongs to one thread block cluster of S = 1,
// 2, 4 or 8 blocks, each quantizing 128 / S of its rows. S grows while the
// grid holds fewer than about four blocks an SM, so a small layer (fc2 is
// one tile) runs on many SMs instead of one. Each block's count goes into
// the shared memory of the cluster's first block, which sums the S counts in
// a fixed order and writes nnz and mask once: no atomics, deterministic.
// Within a block a warp steps over its rows R at a time: a lane is a
// (sub-row, group) pair over the G groups of 4 columns that cover the tile's
// live columns (G a power of two from 4 to 32, R = 32 / G; c0's 64 columns
// give G = 16, two rows a step). Each lane loads its 4 x with one 16-byte
// load (scalar loads where cols % 4 != 0), draws its 4 u with one Philox
// call, and stores its 4 k as one 4-byte word; kBatch steps' loads are in
// flight before any is used. The lane's 4 occupancy bits are a nibble of
// the row's 128-bit bitmap segment; xor-shuffles OR each 8 groups' nibbles
// into one 32-bit wire word (4 groups' into its low half for G = 4), which
// the first lane stores. Columns past 4G are padding: 16-byte zero stores
// for k and zero words for the bitmap. The count is the sum of the nibbles'
// popcounts, reduced per warp and then in shared memory.
//
// Precision: the division is __fdiv_rn (IEEE round to nearest), never a
// multiply by a reciprocal, and every add and multiply is __fadd_rn /
// __fmul_rn, so nvcc cannot contract anything into an FMA. k therefore agrees
// bit for bit with src/repro/core/nsd.py::nsd_indices for the same
// (x, nu, delta), on the fed route and, given u from the same key, on the key
// route.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Chosen on the H100 over VGG11's eleven cotangents at batch 128: two warp
// steps' loads in flight, with registers capped for four blocks an SM, gave
// the least summed time of the settings tried (more steps in flight, no
// cap, 128 or 512 threads, a denser split).
constexpr int kBatch = 2;  // warp steps whose loads a thread keeps in flight
constexpr int kMinBlocks = 4;  // blocks an SM holds (__launch_bounds__)
constexpr int kMaxSlabs = 8;  // blocks a tile may be split over (a cluster)
constexpr int kBlocksPerSm = 4;  // the grid size up to which tiles are split

// Split arrive / wait on the cluster barrier: arrive when the block starts,
// wait before the first write to another block's shared memory.
__device__ __forceinline__ void barrier_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void barrier_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float unit_uniform(uint32_t word) {
  return __fadd_rn(__fmul_rn(static_cast<float>(word >> 8), 0x1p-24f), -0.5f);
}

__device__ __forceinline__ int8_t nsd_level(float x, float nu, float safe,
                                            bool live) {
  float v = floorf(__fadd_rn(__fdiv_rn(__fadd_rn(x, nu), safe), 0.5f));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return live ? static_cast<int8_t>(static_cast<int>(v)) : int8_t(0);
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The 4 floats of a lane from p[idx .. idx+3], zeros where dead: one 16-byte
// load when all four are live and vec (cols % 4 == 0, 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        int64_t idx, int nlive, bool vec) {
  if (nlive == 4 && vec) return __ldg(reinterpret_cast<const float4*>(p + idx));
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nlive) f[j] = __ldg(p + idx + j);
  return make_float4(f[0], f[1], f[2], f[3]);
}

// One block quantizes 128 / S rows (a slab) of one 128 x 128 tile; the S
// slabs of a tile are one thread block cluster, so the tile's count is summed
// in rank 0's shared memory and written once. A warp takes R rows of its
// slab at a time: lanes are (sub-row, group) pairs over the G groups of 4
// columns that cover the tile's live columns (G a power of two, 4..32, so
// R = 32 / G), and columns past 4G, all padding, are zero-filled apart.
template <bool kFed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
nsd_quant_kernel(const float* __restrict__ x, const float* __restrict__ nu,
                 uint32_t key0, uint32_t key1, const float* __restrict__ delta_p,
                 int8_t* __restrict__ k, uint32_t* __restrict__ bitmap,
                 int32_t* __restrict__ nnz, int32_t* __restrict__ mask,
                 int cols, int64_t count, int np, int slabs, bool vec) {
  barrier_cluster_arrive_relaxed();  // this block has started
  const float delta = *delta_p;
  const float safe = fmaxf(delta, FLT_MIN);
  const bool live_delta = delta > 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = blockIdx.x % slabs;
  const int tile_row = blockIdx.x / slabs, tile_col = blockIdx.y;
  const int col0 = tile_col * kTile;
  // G: groups of 4 columns over the tile's live columns, rounded up to a
  // power of two (at least 4, so the padding past 4G is 16-byte aligned)
  const int live_groups = min((cols - col0 + 3) / 4, kTile / 4);
  int G = 4;
  while (G < live_groups) G <<= 1;
  const int R = 32 / G;  // rows per warp step
  const int g = lane % G, sub = lane / G;
  const int c = col0 + 4 * g;  // the first of the lane's 4 columns
  const int col_live = min(max(cols - c, 0), 4);
  const int rows_per_warp = kTile / slabs / kWarps;
  const int64_t row0 = static_cast<int64_t>(tile_row) * kTile +
                       slab * (kTile / slabs) + warp * rows_per_warp;
  const int pad_bytes = kTile - 4 * G;  // per row, a multiple of 16
  const int words_live = (G + 7) / 8;   // bitmap words the lanes form

  int total = 0;
  for (int b = 0; b < rows_per_warp; b += kBatch * R) {
    float4 xv[kBatch], nv[kBatch];
    int nlive[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int rr = b + i * R + sub;  // row within the warp's share
      const int64_t idx = (row0 + rr) * cols + c;
      const int64_t left = count - idx;  // live elements from idx on
      nlive[i] = rr >= rows_per_warp || left <= 0 ? 0
                 : left < col_live ? static_cast<int>(left) : col_live;
      xv[i] = load4(x, idx, nlive[i], vec);
      if (kFed) nv[i] = load4(nu, idx, nlive[i], vec);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int rr = b + i * R + sub;
      const int64_t r = row0 + rr;
      if (!kFed) {
        nv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (nlive[i] > 0) {
          const uint4 w = philox4x32_10(static_cast<uint32_t>(c >> 2),
                                        static_cast<uint32_t>(r), key0, key1);
          nv[i] = make_float4(__fmul_rn(unit_uniform(w.x), delta),
                              __fmul_rn(unit_uniform(w.y), delta),
                              __fmul_rn(unit_uniform(w.z), delta),
                              __fmul_rn(unit_uniform(w.w), delta));
        }
      }
      int8_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = j < nlive[i] ? nsd_level(at(xv[i], j), at(nv[i], j), safe, live_delta)
                            : int8_t(0);
      const bool row_ok = rr < rows_per_warp;
      const int64_t out = r * np + c;
      if (row_ok) *reinterpret_cast<char4*>(k + out) = make_char4(q[0], q[1], q[2], q[3]);
      const uint32_t nib = (q[0] != 0) | (q[1] != 0) << 1 | (q[2] != 0) << 2 |
                           (q[3] != 0) << 3;
      total += __popc(nib);
      if (bitmap != nullptr) {
        // lanes of groups 8w .. 8w+7 of one row hold the 32 elements of the
        // segment's word w (for G = 4, its low 16)
        uint32_t word = nib << (4 * (g & 7));
        for (int s = 1; s < G && s < 8; s <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, s);
        if (row_ok && (g & 7) == 0) bitmap[out >> 5] = word;
      }
    }
    // zeros in the padding columns past 4G of this step's rows, and in
    // their bitmap words
    const int step_rows = min(kBatch * R, rows_per_warp - b);
    const int pad_units = pad_bytes / 16;
    for (int z = lane; z < step_rows * pad_units; z += 32) {
      const int64_t r = row0 + b + z / pad_units;
      *reinterpret_cast<uint4*>(k + r * np + col0 + 4 * G + 16 * (z % pad_units)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (bitmap != nullptr) {
      const int pad_words = 4 - words_live;
      for (int z = lane; z < step_rows * pad_words; z += 32) {
        const int64_t r = row0 + b + z / pad_words;
        bitmap[((r * np + col0) >> 5) + words_live + z % pad_words] = 0u;
      }
    }
  }

  for (int s = 16; s > 0; s >>= 1) total += __shfl_down_sync(0xffffffffu, total, s);
  __shared__ int warp_counts[kWarps];
  __shared__ int slab_counts[kMaxSlabs];
  if (lane == 0) warp_counts[warp] = total;
  __syncthreads();
  barrier_cluster_wait();  // every block of the cluster has started
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w];
    cluster.map_shared_rank(slab_counts, 0)[slab] = sum;
  }
  cluster.sync();
  if (slab == 0 && threadIdx.x == 0) {
    int sum = 0;
    for (int s = 0; s < slabs; ++s) sum += slab_counts[s];  // a fixed order
    const int t = tile_row * gridDim.y + tile_col;
    if (nnz != nullptr) nnz[t] = sum;
    if (mask != nullptr) mask[t] = sum > 0;
  }
}

// u (rows, cols) f32: one thread draws one Philox block of 4 columns.
__global__ void __launch_bounds__(kThreads)
philox_uniform_kernel(uint32_t key0, uint32_t key1, float* __restrict__ u,
                      int rows, int cols) {
  const int groups = (cols + 3) / 4;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= static_cast<int64_t>(rows) * groups) return;
  const int r = static_cast<int>(g / groups), cg = static_cast<int>(g % groups);
  const uint4 w = philox4x32_10(static_cast<uint32_t>(cg), static_cast<uint32_t>(r),
                                key0, key1);
  const float4 v = make_float4(unit_uniform(w.x), unit_uniform(w.y),
                               unit_uniform(w.z), unit_uniform(w.w));
  const int64_t base = static_cast<int64_t>(r) * cols + 4 * cg;
  if (cols % 4 == 0) {
    *reinterpret_cast<float4*>(u + base) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * cg + j < cols) u[base + j] = at(v, j);
}

}  // namespace

// x: `count` live f32 in a (rows, cols) row-major view; nu: null (draw from
// `key`) or x's shape; delta: one f32 on the device; k: (Tp, Np) int8 with
// Tp, Np the 128-multiples above rows, cols; bitmap: (Tp, Np/8) uint8 or
// null; nnz, mask: (Tp/128, Np/128) int32 or null. x and nu 16-byte aligned
// (checked by the Python wrapper).
extern "C" int nsd_quant_launch(const float* x, const float* nu,
                                unsigned long long key, const float* delta,
                                int8_t* k, uint8_t* bitmap, int32_t* nnz,
                                int32_t* mask, int rows, int cols, int count,
                                cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles_r = (rows + kTile - 1) / kTile, tiles_c = (cols + kTile - 1) / kTile;
  // split a tile over up to 8 blocks while the grid holds fewer than about
  // four blocks an SM: a small layer then runs on many SMs
  int slabs = 1;
  const int64_t tiles = static_cast<int64_t>(tiles_r) * tiles_c;
  while (slabs < kMaxSlabs && tiles * slabs * 2 <= kBlocksPerSm * sms) slabs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_r * slabs, tiles_c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = cols % 4 == 0;
  const uint32_t k0 = static_cast<uint32_t>(key), k1 = static_cast<uint32_t>(key >> 32);
  uint32_t* words = reinterpret_cast<uint32_t*>(bitmap);
  const int64_t n = count;
  const int np = tiles_c * kTile;
  cudaError_t err;
  if (nu != nullptr)
    err = cudaLaunchKernelEx(&cfg, nsd_quant_kernel<true>, x, nu, k0, k1, delta, k,
                             words, nnz, mask, cols, n, np, slabs, vec);
  else
    err = cudaLaunchKernelEx(&cfg, nsd_quant_kernel<false>, x, nu, k0, k1, delta, k,
                             words, nnz, mask, cols, n, np, slabs, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// u: (rows, cols) f32, 16-byte aligned.
extern "C" int philox_uniform_launch(unsigned long long key, float* u, int rows,
                                     int cols, cudaStream_t stream) {
  const int64_t groups = static_cast<int64_t>(rows) * ((cols + 3) / 4);
  const int blocks = static_cast<int>((groups + kThreads - 1) / kThreads);
  philox_uniform_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32), u, rows, cols);
  return static_cast<int>(cudaGetLastError());
}
