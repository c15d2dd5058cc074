// Hot-position compaction of END-indexed emit planes for Hopper (sm_90a),
// behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, compact.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_batched.py _compact_planes
// (jit at :499-500), which XLA runs as jnp.nonzero over the planes, driven
// by planes_to_sparse (:521-547).
//
// What it computes.  Planes are uint32[P, N], plane p of position i at
// bits[p*N + i].  A position is hot when any of its P words is nonzero.  The
// output is the number of hot positions, their indices in ascending order
// (int64) and their masks hot-major (uint32[count, P]).
//
// How.  Three passes, no atomics, so the order is fixed by construction:
//   1. count_kernel: block b owns the tile [b*kTile, (b+1)*kTile).  Each
//      warp ballots "hot" over 32 neighbouring positions and adds the
//      popcount; the block's sum goes to block_counts[b].
//   2. scan_kernel: one block of 1,024 threads runs an exclusive scan of the
//      block counts (a warp shuffle scan, then a scan of the warp sums,
//      carried across chunks of 1,024 blocks) and writes the total.
//   3. the host reads the total and sizes the outputs (the caller may stop
//      here when a dense download is cheaper); write_kernel walks its tile in
//      the same order as pass 1 and ranks each hot position as block offset
//      + hot positions of the earlier rounds + of the earlier warps + of the
//      lower lanes (ballot & lanemask_lt), then stores its index and masks.
//
// What bounds it on the H100.  Device-memory bandwidth: pass 1 reads the
// planes once (4*P bytes a position, coalesced: a warp reads 128
// consecutive bytes of each plane), pass 3 reads them again and writes
// (8 + 4*P) bytes per hot position.  On the main path (P = 1, 32 Mi
// positions) that is about 2 x 128 MB of reads, some 80 us at 3.35 TB/s, plus
// the host round trip for the total between passes 2 and 3.  The scan of
// 16,384 block counts in one block is a few microseconds.  Left for later
// work: 16-byte vector loads, keeping the pass-1 words in registers for
// pass 3 (one read instead of two), and a decoupled look-back scan that
// fuses the passes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kRounds;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_hot(const uint32_t* __restrict__ bits,
                                       int planes, int64_t n, int64_t i) {
  if (i >= n) return false;
  uint32_t any = 0;
  for (int p = 0; p < planes; ++p) any |= __ldg(bits + p * n + i);
  return any != 0u;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint32_t* __restrict__ bits, int planes, int64_t n,
                 uint32_t* __restrict__ block_counts) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t hot = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    hot += __popc(__ballot_sync(kFull, is_hot(bits, planes, n, i)));
  }
  __shared__ uint32_t warp_hot[kWarps];
  if (lane == 0) warp_hot[warp] = hot;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_hot[w];
    block_counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const uint32_t* __restrict__ block_counts, int64_t num_blocks,
                int64_t* __restrict__ offsets, int64_t* __restrict__ total) {
  __shared__ long long warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int64_t base = 0; base < num_blocks; base += kScanThreads) {
    const int64_t j = base + threadIdx.x;
    const long long v = j < num_blocks ? block_counts[j] : 0;
    long long x = v;  // inclusive scan inside the warp
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp sums
      long long w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const long long inclusive = x + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (j < num_blocks) offsets[j] = carry + inclusive - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint32_t* __restrict__ bits, int planes, int64_t n,
                 const int64_t* __restrict__ offsets, int64_t* __restrict__ idx,
                 uint32_t* __restrict__ masks) {
  __shared__ uint32_t warp_hot[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int64_t pos = offsets[blockIdx.x];  // rank of the round's first hot position
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    const bool hot = is_hot(bits, planes, n, i);
    const uint32_t ballot = __ballot_sync(kFull, hot);
    if (lane == 0) warp_hot[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = 0, round_hot = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_hot[w];
      if (w < warp) before += c;
      round_hot += c;
    }
    if (hot) {
      const int64_t rank = pos + before + __popc(ballot & lanes_below);
      idx[rank] = i;
      for (int p = 0; p < planes; ++p) masks[rank * planes + p] = __ldg(bits + p * n + i);
    }
    pos += round_hot;
    __syncthreads();  // warp_hot is rewritten by the next round
  }
}

int64_t num_blocks_for(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Positions per block of the count and write passes: the caller sizes
// block_counts and offsets as ceil(n / compact_tile()).
extern "C" int compact_tile() { return static_cast<int>(kTile); }

// Passes 1 and 2: block_counts uint32[num_blocks], offsets int64[num_blocks],
// total int64[1].  Returns cudaGetLastError() after the launches.
extern "C" int compact_count(const void* bits, int planes, int64_t n,
                             void* block_counts, void* offsets, void* total,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = num_blocks_for(n);
  auto* counts = static_cast<uint32_t*>(block_counts);
  if (blocks > 0) {
    count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(bits), planes, n, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, blocks, static_cast<int64_t*>(offsets),
                                          static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3: idx int64[total], masks uint32[total, planes], offsets from
// compact_count on the same stream.
extern "C" int compact_write(const void* bits, int planes, int64_t n,
                             const void* offsets, void* idx, void* masks,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = num_blocks_for(n);
  if (blocks == 0) return 0;
  write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), planes, n, static_cast<const int64_t*>(offsets),
      static_cast<int64_t*>(idx), static_cast<uint32_t*>(masks));
  return static_cast<int>(cudaGetLastError());
}
