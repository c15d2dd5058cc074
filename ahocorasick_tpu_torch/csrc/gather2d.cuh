// The probes' 2-D gather on an (8, 128) table for Hopper (sm_90a): one warp a
// row of 128 indices, four a lane.  Included by csrc/probes.cu.
//
// What it computes (probe2.py:56, :86; probe3.py:142; probe6.py:162).  Row i
// of idx is a chain of its own: the sublane-then-lane gather
//   g1[i, c] = tab[(x[i, c] >> 7) & 7][c],  x[i, j] <- (x[i, j] + g1[i, L] [+ r]) & mask,
// L = x[i, j] & 127, reads only its own row (probe3's take_along_axis along
// axis 0 is column by column, along axis 1 within the row); the sublane
// gathers need no exchange at all.  So lane l of a row's warp owns columns
// j = l + 32 q (q = 0..3), computes g1 for them, and the row's g1 crosses
// the warp; no block barrier is needed in the loop.  In the first-tile mode
// only rows 0-7 gather; every other row is (x + 0) & mask at each of reps
// steps, which is x & mask once where reps >= 1 and x where reps == 0.
//
// A lane reads its g1 from one 4 KB shared copy of the table, word
// s * 128 + j, which puts column j = l + 32 q in bank l (no conflict).  The
// row's g1 crosses the warp through a row of 128 words in shared memory
// private to the warp, double-buffered, so one __syncwarp a step orders the
// writes before the reads (a lane reaches the writes into a buffer two
// steps on only past the __syncwarp that every lane's read of it preceded).
// The table's words in registers (three levels of selects) and the exchange
// by four __shfl_sync and a select lost to this form on the card (PERF.md,
// PR 24).
//
// What bounds it.  A step is a latency chain: the shared load of g1, the
// exchange, an add and a mask.  The yardstick is its latency floor,
// reps x the step of one warp on the idle card x the waves (one at 512 rows:
// 512 warps fit the card at once); chip_smoke.py measures it.

#include <cstdint>

#include <cuda_runtime.h>

namespace g2 {

enum Mode { kSublaneOnce = 0, kSublaneChain = 1, kGather2dFirst = 2, kGather2dAll = 3 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // rows a block: kernels/probes.G2_MAX_WARPS

// The 1,024 table words into the block's shared copy: 16-byte loads, all of
// a thread's issued before any is stored, where the table is 16-byte
// aligned; else word loads.
__device__ __forceinline__ void stage_table(const uint32_t* __restrict__ tab, uint32_t* s_tab) {
  if ((reinterpret_cast<uintptr_t>(tab) & 15u) == 0u) {
    const uint4* t4 = reinterpret_cast<const uint4*>(tab);
    uint4 v[256 / 32];
#pragma unroll
    for (int k = 0; k < 256 / 32; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 256) v[k] = __ldg(t4 + i);
    }
#pragma unroll
    for (int k = 0; k < 256 / 32; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 256) reinterpret_cast<uint4*>(s_tab)[i] = v[k];
    }
  } else {
    for (int w = threadIdx.x; w < 1024; w += blockDim.x) s_tab[w] = __ldg(tab + w);
  }
}

// The rows' words out, or with sum_out the block's sum added once (the
// int32 sum wrapped; rows past the end add 0).
__device__ __forceinline__ void write_rows(const uint32_t (&x)[4], int64_t row, int64_t rows,
                                           int sum_out, uint32_t* __restrict__ out,
                                           uint32_t* s_sums) {
  const int lane = threadIdx.x & 31;
  if (sum_out) {
    uint32_t s = __reduce_add_sync(kFull, x[0] + x[1] + x[2] + x[3]);
    if (lane == 0) s_sums[threadIdx.x >> 5] = s;
    __syncthreads();  // after every warp's loop
    if (threadIdx.x == 0) {
      for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) s += s_sums[w];
      atomicAdd(out, s);
    }
  } else if (row < rows) {
    uint32_t* o = out + row * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[lane + 32 * q] = x[q];
  }
}

// The single sublane gather, out[i, j] = tab[idx[i, j] & 7][j]: a thread an
// index, blocks of 8 rows (1,024 threads: gather2d_shape), each staging its
// shared copy of the table one word a thread while the indices load.
__global__ void __launch_bounds__(128 * kMaxWarps)
    sublane_kernel(const uint32_t* __restrict__ tab, const uint32_t* __restrict__ idx,
                   int sum_out, uint32_t* __restrict__ out) {
  __shared__ uint32_t s_tab[1024];
  __shared__ uint32_t s_sums[4 * kMaxWarps];
  const int j = threadIdx.x & 127;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x;
  s_tab[threadIdx.x] = tab[threadIdx.x];
  uint32_t x = idx[at];
  __syncthreads();
  x = s_tab[(x & 7u) * 128 + j];
  if (sum_out) {
    x = __reduce_add_sync(kFull, x);
    if ((threadIdx.x & 31) == 0) s_sums[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) x += s_sums[w];
      atomicAdd(out, x);
    }
  } else {
    out[at] = x;
  }
}

// Block of 32 W threads (W = blockDim.x / 32 <= kMaxWarps): warp w takes row
// blockIdx.x * W + w of rows.  out: uint32[rows][128], or uint32[1] (zeroed)
// with sum_out, the int32 sum wrapped (one atomic add a block).  The sublane
// chain needs no exchange: its step needs only tab & 7, so a lane packs the
// 8 x 3 steering bits of each of its columns into a word.  (The single
// sublane gather is sublane_kernel.)
__global__ void __launch_bounds__(32 * kMaxWarps)
    gather2d_kernel(const uint32_t* __restrict__ tab, const uint32_t* __restrict__ idx,
                    int64_t rows, int reps, uint32_t mask, int mode, int sum_out,
                    uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_tab[1024];
  __shared__ uint32_t s_rows[kMaxWarps][256];  // two buffers a warp
  __shared__ uint32_t s_sums[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first_row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5);
  const int64_t row = first_row + warp;
  // block-uniform: whether any of the block's rows gathers
  const bool gathers = mode == kGather2dAll || (mode == kGather2dFirst && first_row < 8);
  uint32_t x[4] = {0u, 0u, 0u, 0u};
  if (row < rows) {  // issued before the table's loads, consumed after them
    const uint32_t* in = idx + row * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = in[lane + 32 * q];
  }
  if (gathers) {
    stage_table(tab, s_tab);
    __syncthreads();  // once, before any step
  }
  if (row < rows) {
    if (mode == kSublaneChain) {
      uint32_t steer[4] = {0u, 0u, 0u, 0u};  // bits 3 s .. 3 s + 2: tab[s][j] & 7
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          steer[q] |= (__ldg(tab + s * 128 + lane + 32 * q) & 7u) << (3 * s);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] &= 7u;
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = ((steer[q] >> (3u * x[q])) + x[q]) & 7u;
      }
    } else if (mode == kGather2dAll || row < 8) {  // warp-uniform
      const uint32_t add_r = mode == kGather2dAll ? 1u : 0u;
      const uint32_t* cols = s_tab + lane;  // the lane's columns: cols[s * 128 + 32 q]
      uint32_t* row_s = s_rows[warp];
      for (int r = 0; r < reps; ++r) {
        // all four loads before any store: the stores may alias them, so
        // interleaved they would run one load's latency after another
        uint32_t g1[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g1[q] = cols[((x[q] >> 7) & 7u) * 128u + 32u * q];
        uint32_t* buf = row_s + 128 * (r & 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) buf[lane + 32 * q] = g1[q];
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = buf[x[q] & 127u];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = (x[q] + v[q] + add_r * static_cast<uint32_t>(r)) & mask;
      }
    } else if (reps > 0) {  // a row past the first tile: (x + 0) & mask, reps times
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] &= mask;
    }
  }
  write_rows(x, row, rows, sum_out, out, s_sums);
}

// Checks the arguments and launches `blocks` blocks of `warps` rows (a
// warp a row; the single sublane gather a thread an index).
inline cudaError_t launch(const uint32_t* tab, const uint32_t* idx, int64_t rows, int reps,
                          uint32_t mask, int mode, int sum_out, int warps, int64_t blocks,
                          uint32_t* out, cudaStream_t st) {
  if (rows < 8 || rows % 8 != 0 || reps < 0 || mode < kSublaneOnce || mode > kGather2dAll ||
      warps < 1 || warps > kMaxWarps || blocks < 1 || blocks * warps < rows ||
      (blocks - 1) * warps >= rows || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (mode == kSublaneOnce) {
    if (warps != kMaxWarps) return cudaErrorInvalidValue;
    sublane_kernel<<<static_cast<unsigned>(blocks), 128 * kMaxWarps, 0, st>>>(tab, idx, sum_out,
                                                                              out);
  } else {
    gather2d_kernel<<<static_cast<unsigned>(blocks), 32 * warps, 0, st>>>(
        tab, idx, rows, reps, mask, mode, sum_out, out);
  }
  return cudaGetLastError();
}

}  // namespace g2
