// The probes' chain a window for Hopper (sm_90a), its windows staged in
// shared memory.  Included by csrc/probes.cu.
//
// What it computes (probe7.py:152 part_b, flat table[s*AP+c] and 2-D
// table[s, c]; :183 part_c; lax.scan).  One chain a window from s = 0 over
// every class of the window, s <- tab[chain_at(s, c)], and the int32 sum of
// the final states.  The hashed tables do not synchronize, so only a serial
// walk a window gives the JAX answer: a thread a window.
//
// What bounds it.  Each step is one dependent load from the table, so a
// call takes at least its steps x the latency of the table's placement (L1,
// L2 or device memory) x the waves of windows: its latency floor, measured
// for each placement by bench/scan_variants.py window_floor.  The first
// design (PR 28, kept as window_chain_first in bench/scan_variants.cu) read
// each window's classes from its own row of global memory: at int32 classes
// a row is 2,096 bytes, so a warp step's class load touched 32 lines, in
// the L1 / LSU pipe that the step's table load waits in.
//
// The design.  The walk's only global load is the table's (__ldg).  Each
// warp stages its 32 windows' classes in shared memory in tiles of
// kTileBytes of a row (the whole row where it is shorter), two buffers a
// warp, so the walk waits only for the first tile.  The warp copies a tile
// with cp.async in 16-byte units, two windows an instruction (lane l reads
// 16 bytes of window 2 p + l / 16 at l % 16: 256 contiguous bytes a
// half-warp, whole sectors), and spreads the copy of tile t + 1 over the
// first half of tile t's walk, two instructions a vector, so that the
// windows reach L2 as a steady stream and not as a burst at each tile; one
// cp.async.wait_group and a __syncwarp at the tile's end make the other
// lanes' copies visible.  A lane's piece of a tile lies at lane x stride,
// the stride an odd number of 16-byte units, so the 8 lanes of each
// quarter-warp read their 16-byte vectors from 8 distinct bank groups: a
// vector (16 bytes: 4, 8 or 16 classes) is one conflict-free ld.shared, read
// one vector ahead of its use.  The kernel prefers the carve-out with the
// most L1 that fits (the table's rows at n = 4,096, 512 KB, partly fit L1).
// A row that is not 16-byte aligned (its bytes or the windows' base)
// cannot be copied in 16-byte units; it takes the first design's direct
// loads (csrc/probes.cu window_kernel).  kernels/probes.window_plan mirrors
// the tile plan.  The arms that lost the A/B (PERF.md, PR 29): TMA bulk
// copies (a lane's piece an instruction, on an mbarrier), cp.async by each
// lane of its own piece (the whole next tile at the tile's end, or two
// chunks a vector), ld.global.cg and ld.global.nc.L1::no_allocate for the
// table load, blocks of 32 windows.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace wc {

constexpr int kLanes = 32;
constexpr int kVec = 16;         // bytes of a copy unit and of a shared read
constexpr int kTileBytes = 256;  // a window's bytes a tile: kernels/probes.WINDOW_TILE_BYTES
constexpr int kWarps = 2;        // warps a block: kernels/probes.WINDOW_WARPS
constexpr int kPairs = kLanes / 2;  // copy instructions a full tile: two windows each

// The table word a step reads: flat (kRows false), min(s * stride + c,
// last) in 32-bit arithmetic, as the JAX uint32 index wraps and XLA clamps a
// gather; by rows (kRows), row min(s, rows_last) and column min(c, stride -
// 1), as XLA clamps each index of table[s, c].
template <bool kRows>
__device__ __forceinline__ uint32_t chain_at(uint32_t s, uint32_t c, uint32_t stride,
                                             uint32_t last, uint32_t rows_last) {
  return kRows ? min(s, rows_last) * stride + min(c, stride - 1u) : min(s * stride + c, last);
}

// The tile plan: a tile holds tile_bytes(row) bytes of each window's row;
// a lane's piece of a buffer starts at lane x tile_stride(tb), an odd
// number of 16-byte units; a warp takes two buffers of 32 pieces.
__host__ __device__ __forceinline__ int tile_bytes(int64_t row_bytes) {
  return row_bytes < kTileBytes ? static_cast<int>(row_bytes) : kTileBytes;
}
__host__ __device__ __forceinline__ int tile_stride(int tb) {
  return ((tb / kVec) & 1) ? tb : tb + kVec;
}
__host__ __device__ __forceinline__ int warp_shared(int stride) { return 2 * kLanes * stride; }

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The steps of one 16-byte vector of classes (16 / kCB of them).
template <int kCB, bool kRows>
__device__ __forceinline__ uint32_t walk_vec(uint32_t s, const uint4& v,
                                             const uint32_t* __restrict__ tab, uint32_t stride,
                                             uint32_t last, uint32_t rows_last) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int q = 0; q < 4 / kCB; ++q) {
      uint32_t c;
      if constexpr (kCB == 4) {
        c = words[k];
      } else {
        c = (words[k] >> (8 * kCB * q)) & ((1u << (8 * kCB)) - 1u);
      }
      s = __ldg(tab + chain_at<kRows>(s, c, stride, last, rows_last));
    }
  }
  return s;
}

// A warp's 32 windows [first, first + 32), each of row_bytes (a multiple
// of 16, the base 16-byte aligned), walked over tiles of tb bytes staged in
// `warp_smem` (warp_shared(tstride) bytes, 16-byte aligned).  Windows past n
// are not copied: their lanes walk whatever the buffers hold (the clamps
// keep every load in the table) and return 0.
template <int kCB, bool kRows>
__device__ __forceinline__ uint32_t staged_walk(const uint32_t* __restrict__ tab, uint32_t last,
                                                uint32_t rows_last, uint32_t stride,
                                                const uint8_t* __restrict__ windows,
                                                int64_t row_bytes, int64_t n, int64_t first,
                                                int tb, int tstride, uint8_t* warp_smem) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int ntiles = row_bytes > 0 ? static_cast<int>((row_bytes + tb - 1) / tb) : 0;
  if (ntiles == 0) return 0u;
  const uint8_t* piece = warp_smem + lane * tstride;  // this lane's piece of buffer 0
  const int buf_bytes = kLanes * tstride;
  auto vectors = [&](int t) {
    return static_cast<int>(min(static_cast<int64_t>(tb), row_bytes - int64_t{t} * tb)) / kVec;
  };
  // Lane `chunk` of half-warp `half` copies chunk `chunk` of window
  // 2 p + half, p = 0, 1, ... in turn: pairs_own windows (fewer in the last
  // warp).  cp_src, cp_dst: its next copy of the tile being copied;
  // cp_left: the windows left to it.
  const int half = lane >> 4, chunk = lane & 15;
  const int valid = static_cast<int>(min(n - first, int64_t{kLanes}));
  const int pairs_own = (valid - half + 1) / 2;
  const uint8_t* pair_src = windows + (first + half) * row_bytes + chunk * kVec;
  const uint32_t pair_dst = static_cast<uint32_t>(
      __cvta_generic_to_shared(warp_smem + half * tstride + chunk * kVec));
  const uint8_t* cp_src = pair_src;
  uint32_t cp_dst = pair_dst;
  int cp_left = 0;
  auto start_tile = [&](int t, int nchunks) {
    cp_src = pair_src + int64_t{t} * tb;
    cp_dst = pair_dst + (t & 1) * buf_bytes;
    cp_left = chunk < nchunks ? pairs_own : 0;
  };
  auto copy_next = [&]() {
    if (cp_left > 0) cp16(cp_dst, cp_src);
    --cp_left;
    cp_src += 2 * row_bytes;
    cp_dst += 2 * tstride;
  };
  start_tile(0, vectors(0));
  for (int p = 0; p < kPairs; ++p) copy_next();
  cp_commit();
  cp_wait_all();
  __syncwarp();  // the other lanes' copies
  uint32_t s = 0u;
  int t = 0, j = 0, nv = vectors(0);
  int nv_next = ntiles > 1 ? vectors(1) : 0;
  if (nv_next > 0) start_tile(1, nv_next);
  uint4 cur = *reinterpret_cast<const uint4*>(piece);
  for (;;) {
    uint4 nxt = cur;
    bool more = true;
    if (j + 1 < nv) {
      nxt = *reinterpret_cast<const uint4*>(piece + (t & 1) * buf_bytes + (j + 1) * kVec);
    } else if (t + 1 < ntiles) {
      // cur holds tile t's last vector: tile t + 1 has been copied since
      // the middle of tile t; every lane is past its reads of buffer t & 1
      cp_wait_all();
      __syncwarp();
      nxt = *reinterpret_cast<const uint4*>(piece + ((t + 1) & 1) * buf_bytes);
    } else {
      more = false;
    }
    s = walk_vec<kCB, kRows>(s, cur, tab, stride, last, rows_last);
    // tile t + 1 into buffer (t + 1) & 1 (whose tile t - 1 every lane has
    // walked: the __syncwarp at tile t's start): windows 4 j .. 4 j + 3 with
    // vector j of tile t, the group committed with the last of them (tile t
    // is full, 16 vectors, wherever a tile follows it)
    if (nv_next > 0 && j < kPairs / 2) {
      copy_next();
      copy_next();
      if (j == kPairs / 2 - 1) cp_commit();
    }
    if (!more) break;
    if (++j == nv) {
      ++t;
      j = 0;
      nv = nv_next;
      nv_next = t + 1 < ntiles ? vectors(t + 1) : 0;
      if (nv_next > 0) start_tile(t + 1, nv_next);
    }
    cur = nxt;
  }
  return lane < valid ? s : 0u;
}

// kWarps warps a block, each with its own warp_shared(tstride) bytes of
// dynamic shared memory; each warp adds its chains' final states into out.
template <int kCB, bool kRows>
__global__ void __launch_bounds__(kWarps * kLanes)
    staged_kernel(const uint32_t* __restrict__ tab, uint32_t last, uint32_t rows_last,
                  uint32_t stride, const uint8_t* __restrict__ windows, int64_t row_bytes,
                  int64_t n, int tb, int tstride, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / kLanes;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kLanes;
  if (first >= n) return;  // the whole warp
  uint32_t s = staged_walk<kCB, kRows>(tab, last, rows_last, stride, windows, row_bytes, n, first,
                                       tb, tstride, smem + warp * warp_shared(tstride));
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & (kLanes - 1)) == 0) atomicAdd(out, s);
}

// windows: [n] rows of row_bytes (a multiple of 16, the base 16-byte
// aligned).
template <int kCB, bool kRows>
cudaError_t launch_staged(const uint32_t* tab, uint32_t last, uint32_t rows_last, uint32_t stride,
                          const uint8_t* windows, int64_t row_bytes, int64_t n, uint32_t* out,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(staged_kernel<kCB, kRows>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return err;
  const int tb = tile_bytes(row_bytes);
  const int ts = tile_stride(tb);
  const int64_t per = int64_t{kWarps} * kLanes;
  const unsigned grid = static_cast<unsigned>((n + per - 1) / per);
  staged_kernel<kCB, kRows><<<grid, kWarps * kLanes, kWarps * warp_shared(ts), st>>>(
      tab, last, rows_last, stride, windows, row_bytes, n, tb, ts, out);
  return cudaGetLastError();
}

}  // namespace wc
