// Levels compact and expand for Hopper (sm_90a): the chunk-local kernels and
// the one-launch wire kernels.
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
//
// The wire kernels also do what the reference leaves to XLA ops around its
// pallas_call (src/repro/quant/wire.py::_compact_pallas / _expand_pallas):
// the exclusive prefix of the per-chunk counts, which places each chunk's
// levels in the tensor's one compacted stream, and the bitmap. A lane's 8
// bytes are exactly one byte of the LSB-first wire bitmap, so compact writes
// the bitmap from its non-zero masks and expand reads it in place of a mask.
// The prefix across blocks is a single-pass decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016): a block of 8 warps takes 32 chunks, publishes its count and then
// its inclusive prefix in one 64-bit status word (flag and value, release
// store), and reads its predecessors' words (acquire loads), 32 at a time,
// until one holds a prefix. A block's place in the scan is an atomic ticket,
// not blockIdx: it only ever waits on blocks that took a ticket before it and
// so are running. Compact writes the block's levels to [start, start +
// count) and its zeros to the block's own share of [nnz, n) counted from the
// end (the zeros of the chunks before it are Z = 256 c0 - start), so every
// byte of the output is written once, with no memset of it and no host read
// of nnz. The status words and the ticket are cleared by one cudaMemsetAsync
// on the caller's stream inside the launch call, so a CUDA graph replays it.
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


// ---------------------------------------------------------------------------
// The wire kernels
// ---------------------------------------------------------------------------

constexpr int kWireRounds = 4;                     // chunks per warp
constexpr int kWireChunks = kWarps * kWireRounds;  // chunks per block
constexpr int kWireBytes = kWireChunks * kChunk;
static_assert(kWireChunks == 32, "warp 0 scans the block's chunk counts");

// Look-back status word: flag in the high half, value in the low half. 0 =
// nothing yet; kAggregate = the block's own count; kPrefix = the inclusive
// prefix of every block up to and including it.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The block's tile in the scan, by arrival; status[gridDim.x] is the ticket.
__device__ __forceinline__ int take_ticket(unsigned long long* status, int* s_tile) {
  if (threadIdx.x == 0)
    *s_tile = static_cast<int>(atomicAdd(status + gridDim.x, 1ull));
  __syncthreads();
  return *s_tile;
}

// Warp 0 only, every lane: turn counts[0..32) into the chunks' offsets in
// the block, publish the block's total, look back for the block's global
// start and publish its inclusive prefix. Leaves start and total in shared.
__device__ void block_offsets(unsigned long long* status, int tile, int lane,
                              int* counts, int* s_start, int* s_total) {
  int total;
  counts[lane] = warp_exclusive_scan(counts[lane], lane, total);
  int start = 0;
  if (tile == 0) {
    if (lane == 0) store_release(status, kPrefix | static_cast<unsigned>(total));
  } else {
    if (lane == 0) store_release(status + tile, kAggregate | static_cast<unsigned>(total));
    for (int end = tile;; end -= 32) {
      const int j = end - 1 - lane;  // lane 0 reads the nearest tile
      unsigned long long s = j >= 0 ? load_acquire(status + j) : kPrefix;
      while (__any_sync(kFull, (s >> 32) == 0)) {
        if ((s >> 32) == 0) s = load_acquire(status + j);
      }
      const unsigned prefixes = __ballot_sync(kFull, (s >> 32) == 2);
      const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
      int v = lane <= stop ? static_cast<int>(s & 0xffffffffu) : 0;
#pragma unroll
      for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      start += v;
      if (prefixes) break;
    }
    if (lane == 0)
      store_release(status + tile, kPrefix | static_cast<unsigned>(start + total));
  }
  if (lane == 0) {
    *s_start = start;
    *s_total = total;
  }
}

// Block-wide store of len bytes to dst, from src (dst and src equal mod 16)
// or zeros: byte stores up to the first 16-byte boundary and after the last,
// 16-byte stores between.
template <bool kZeros>
__device__ __forceinline__ void block_store(int8_t* dst, const uint8_t* src, int len) {
  const int t = threadIdx.x;
  const int head = min(len, static_cast<int>(-reinterpret_cast<uintptr_t>(dst) & 15));
  const int body = (len - head) >> 4;
  const int done = head + (body << 4);
  if (t < head) dst[t] = kZeros ? 0 : static_cast<int8_t>(src[t]);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = t; i < body; i += kThreads)
    d[i] = kZeros ? make_uint4(0u, 0u, 0u, 0u)
                  : reinterpret_cast<const uint4*>(src + head)[i];
  if (t < len - done) dst[done + t] = kZeros ? 0 : static_cast<int8_t>(src[done + t]);
}

// k (C, 256) -> levels (C*256,): the non-zeros in flat order, then zeros;
// bitmap (C, 32) LSB first; nnz.
__global__ void __launch_bounds__(kThreads)
levels_compact_wire_kernel(const int8_t* __restrict__ k, int8_t* __restrict__ levels,
                           uint8_t* __restrict__ bitmap, int32_t* __restrict__ nnz,
                           unsigned long long* __restrict__ status, int C) {
  __shared__ __align__(16) uint8_t buf[kWireBytes + 16];
  __shared__ int counts[kWireChunks];
  __shared__ int s_tile, s_start, s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(status, &s_tile);
  const int c0 = tile * kWireChunks;

  // chunk b = r * kWarps + warp of the block: each round reads 2 KB in a row
  uint2 v[kWireRounds];
#pragma unroll
  for (int r = 0; r < kWireRounds; ++r) {
    const int c = c0 + r * kWarps + warp;  // uniform across the warp
    v[r] = c < C ? *reinterpret_cast<const uint2*>(k + static_cast<size_t>(c) * kChunk +
                                                   lane * kPerLane)
                 : make_uint2(0u, 0u);
  }
  int slot[kWireRounds];
#pragma unroll
  for (int r = 0; r < kWireRounds; ++r) {
    const int b = r * kWarps + warp, c = c0 + b;
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) m |= static_cast<uint32_t>(byte_of(v[r], j) != 0) << j;
    int total;
    slot[r] = warp_exclusive_scan(__popc(m), lane, total);
    if (lane == 0) counts[b] = total;
    if (c < C) bitmap[static_cast<size_t>(c) * 32 + lane] = static_cast<uint8_t>(m);
  }
  __syncthreads();
  if (warp == 0) block_offsets(status, tile, lane, counts, &s_start, &s_total);
  __syncthreads();
  const int start = s_start, total = s_total;
  const int shift = start & 15;  // buf + shift and levels + start agree mod 16
#pragma unroll
  for (int r = 0; r < kWireRounds; ++r) {
    int p = shift + counts[r * kWarps + warp] + slot[r];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const uint32_t x = byte_of(v[r], j);
      if (x) buf[p++] = static_cast<uint8_t>(x);
    }
  }
  __syncthreads();
  block_store<false>(levels + start, buf + shift, total);
  const int valid = min(kWireChunks, C - c0);
  const int zeros_before = c0 * kChunk - start, zeros = valid * kChunk - total;
  block_store<true>(levels + (C * kChunk - zeros_before - zeros), nullptr, zeros);
  if (threadIdx.x == 0 && c0 + valid == C) *nnz = start + total;
}

// levels (C*256,) compacted in flat order, bitmap (C, 32) -> out (C, 256).
__global__ void __launch_bounds__(kThreads)
levels_expand_wire_kernel(const int8_t* __restrict__ levels,
                          const uint8_t* __restrict__ bitmap, int8_t* __restrict__ out,
                          unsigned long long* __restrict__ status, int C) {
  __shared__ __align__(16) uint8_t buf[kWireBytes + 32];
  __shared__ int counts[kWireChunks];
  __shared__ int s_tile, s_start, s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(status, &s_tile);
  const int c0 = tile * kWireChunks;

  uint32_t bits[kWireRounds];
  int slot[kWireRounds];
#pragma unroll
  for (int r = 0; r < kWireRounds; ++r) {
    const int b = r * kWarps + warp, c = c0 + b;
    bits[r] = c < C ? bitmap[static_cast<size_t>(c) * 32 + lane] : 0u;
    int total;
    slot[r] = warp_exclusive_scan(__popc(bits[r]), lane, total);
    if (lane == 0) counts[b] = total;
  }
  __syncthreads();
  if (warp == 0) block_offsets(status, tile, lane, counts, &s_start, &s_total);
  __syncthreads();
  const int start = s_start, total = s_total;
  // stage the aligned 16-byte words that cover [start, start + total); they
  // end at or before C*256, a multiple of 16
  const int shift = start & 15;
  const uint4* src = reinterpret_cast<const uint4*>(levels + (start - shift));
  for (int i = threadIdx.x; i < (shift + total + 15) >> 4; i += kThreads)
    reinterpret_cast<uint4*>(buf)[i] = src[i];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kWireRounds; ++r) {
    const int b = r * kWarps + warp, c = c0 + b;
    int p = shift + counts[b] + slot[r];
    uint32_t o[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if ((bits[r] >> j) & 1u) o[j >> 2] |= static_cast<uint32_t>(buf[p++]) << (8 * (j & 3));
    }
    if (c < C)
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(c) * kChunk + lane * kPerLane) =
          make_uint2(o[0], o[1]);
  }
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

// The wire kernels' workspace: one status word per block and the ticket.
static int wire_clear(unsigned long long* workspace, int workspace_words, int C,
                      cudaStream_t stream, int* blocks) {
  *blocks = (C + kWireChunks - 1) / kWireChunks;
  if (workspace_words < *blocks + 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemsetAsync(
      workspace, 0, sizeof(unsigned long long) * (*blocks + 1), stream));
}

// k: (C, 256) int8; levels: (C*256,) int8; bitmap: (C, 32) uint8; nnz: one
// int32; workspace: at least C/32 + 2 zeroable 8-byte words. C*256 < 2^31,
// pointers 16-byte aligned (checked by the Python wrapper).
extern "C" int levels_compact_wire_launch(const int8_t* k, int8_t* levels,
                                          uint8_t* bitmap, int32_t* nnz,
                                          unsigned long long* workspace,
                                          int workspace_words, int C,
                                          cudaStream_t stream) {
  int blocks;
  const int rc = wire_clear(workspace, workspace_words, C, stream, &blocks);
  if (rc != 0) return rc;
  levels_compact_wire_kernel<<<blocks, kThreads, 0, stream>>>(k, levels, bitmap, nnz,
                                                             workspace, C);
  return static_cast<int>(cudaGetLastError());
}

// levels: (C*256,) int8; bitmap: (C, 32) uint8; out: (C, 256) int8;
// workspace as for compact.
extern "C" int levels_expand_wire_launch(const int8_t* levels, const uint8_t* bitmap,
                                         int8_t* out, unsigned long long* workspace,
                                         int workspace_words, int C,
                                         cudaStream_t stream) {
  int blocks;
  const int rc = wire_clear(workspace, workspace_words, C, stream, &blocks);
  if (rc != 0) return rc;
  levels_expand_wire_kernel<<<blocks, kThreads, 0, stream>>>(levels, bitmap, out,
                                                            workspace, C);
  return static_cast<int>(cudaGetLastError());
}
