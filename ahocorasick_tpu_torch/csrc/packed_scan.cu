// Packed-DFA lane scan for Hopper (sm_90a): match count and END-indexed
// emit planes, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_block.py binds it).
//
// What it replaces.  The TPU kernels ahocorasick_tpu/kernels/scan_block.py
// block_count (pallas_call at :152) and block_emit_planes (:209), and the
// XLA lane-scan loops that compute the same two results over the same packed
// table and differ only in how a TPU does the lookup:
// ops/scan_rowdfa.py rowdfa1_count / rowdfa1_emit_planes and
// ops/scan_batched.py batched_count / batched_emit_planes.
//
// What it computes.  Table entry s*A + c is  next | emit << state_bits
// (uint32), where bit L-1 of emit means "a keyword of length L ends here"
// (suffix chain included).  A window of W classes is `halo` left-context
// classes and C = W - halo body classes; the count kernel sums
// popcount(emit) over the body, the planes kernel writes emit for body
// position j of window b to out[b*C + j], which is flat text order.
//
// Why lanes may start anywhere.  The automaton is halo-synchronizing
// (halo = max_depth, ops/scan_batched.py build_packed): its state after any
// `halo` classes read from the root equals the sequential state, because
// that state is the longest suffix of the text read that is a keyword
// prefix, at most max_depth long.  The count kernel runs one lane per
// window (warm up over the window's halo, then its body).  The planes
// kernel runs K lanes per window: segment k covers body positions
// [k*L, min((k+1)*L, C)) and is warmed from the root over the `halo`
// classes just before it in the same row (the row's own halo for k = 0, body
// classes for k > 0).  The wrapper fixes K and L (kernels/scan_block.py
// segments): K = 4, 2 or 1, the largest that keeps B*K within 65,536 lanes
// and whose segments are at least four halos and 32 steps long, L a
// multiple of 4; K = 1 when halo = 0, where nothing synchronizes.  The plain
// twin takes the same decomposition.
//
// What bounds it on the H100.  Every character is one table load whose
// address depends on the previous load (s -> s*A + c): a lane is a chain of
// dependent loads.  The main path's table (10k keywords: 50,352 states x 32
// classes x 4 B = 6.4 MB) is too big for a block's 227 KB of shared memory
// and is read through L1 and the 50 MB L2; the scans run faster than a
// random chase of a table that size (python -m ahocorasick_tpu_torch.probes),
// so their hot states are few
// and the L1 hit rate decides the pace.  The byte bound (windows in, 4 B per
// body position out) at the main path's 65,536 windows of 12 + 512 classes
// is 0.050 ms.  The planes kernel (0.764 ms in its first, one-lane-per-window
// form) was held back by its memory traffic per step: thread b wrote
// out[b*C + j], so the 32 lanes of a warp stored 4 bytes each 2 KiB apart
// and every store opened its own 32-byte sector, and each lane loaded one
// class a step from its own row.  What this design does about it:
//   * Coalesced stores through shared memory.  Each lane writes the emit
//     words of a tile of kTileSteps = 16 body steps into its own row of a
//     shared-memory tile, padded to 17 words so the 32 lanes' writes of one
//     step fall in 32 banks (17 words, 68 B a lane: 2,048 lanes fit an SM;
//     a 32-step tile's 132 B allow 1,536 and ran slower).  After a
//     __syncwarp the warp stores each lane's contiguous 64-byte run with
//     16-byte stores, 4 lanes per run, so every sector is full.  Where C or
//     L is not a multiple of 4 (a run would not be 16-byte aligned) the runs
//     go out as 4-byte stores, 16 lanes per run, still whole sectors.  (A
//     TMA bulk store of each lane's run, committed while the next tile is
//     scanned, measured no faster: bench/planes_stores.cu keeps it.)
//   * Classes read a word at a time.  A lane loads the aligned 32-bit words
//     that hold its tile's classes (4 uint8 or 2 uint16 classes a load) and
//     funnel-shifts them into place, so its window stays in registers and
//     leaves L1 to the table's hot rows.
//   * More lanes where lanes are few.  Below 65,536 windows the segments
//     raise the lanes in flight up to that count (four lanes per window run
//     about 3x faster than one at 8,192 windows).  At the main path's
//     65,536 windows K = 1: more lanes there only crowd L1 and ran slower.
// The state lives in a register, the table is read through the read-only
// path (__ldg), the flat index is 64-bit, and the count kernel reduces
// in-warp and in-block with one 64-bit atomic per block.  Left for later
// work: the count kernel keeps its byte loads and one lane per window, and
// the sibling planes kernels (table_sharded.cu's planes mode, huge_scan.cu's
// hotstate and split planes, rowdfa2_scan.cu's planes) still store 4 bytes
// per lane at the row stride and load a class a step; small tables are not
// staged in shared memory.  The word loads and the store tile live in
// tile.cuh, which wwl_scan.cu's plane kernel shares.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ table,
                                           uint32_t s, T c,
                                           uint32_t num_classes) {
  return __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
}

template <typename T>
__device__ __forceinline__ uint32_t warm_up(const uint32_t* __restrict__ table,
                                            const T* __restrict__ row, int halo,
                                            uint32_t num_classes,
                                            uint32_t smask) {
  uint32_t s = 0;  // the root (compiler invariant)
  for (int t = 0; t < halo; ++t) s = lookup(table, s, row[t], num_classes) & smask;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, uint32_t num_classes,
                 int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = warm_up(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; ++t) {
      const uint32_t v = lookup(table, s, row[t], num_classes);
      pop += __popc(v >> state_bits);
      s = v & smask;
    }
  }
  // Every thread reaches the shuffles: lanes past num_windows add 0.
  for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = pop;
  __syncthreads();
  if (warp == 0) {
    pop = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
    if (lane == 0 && pop != 0u) atomicAdd(out, static_cast<unsigned long long>(pop));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, int segments, int seg_len, bool vec,
                  uint32_t* __restrict__ out) {
  using tile::kFull;
  using tile::kPitch;
  using tile::kTileSteps;
  __shared__ uint32_t tiles[kThreads * kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;  // window
  const int start = static_cast<int>(g - b * segments) * seg_len;  // first body position
  const int body = width - halo;
  const int len = b < num_windows ? min(seg_len, body - start) : 0;
  const uint32_t smask = (1u << state_bits) - 1u;
  // The segment's warm-up classes are row[start, start + halo), its body
  // classes follow them.
  const T* seg = windows + b * width + start;
  uint32_t s = len > 0 ? warm_up(table, seg, halo, num_classes, smask) : 0u;
  seg += halo;
  uint32_t* row = tiles + threadIdx.x * kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * kPitch;
  const long long dst = b * body + start;
  const int steps = __reduce_max_sync(kFull, len);
  for (int t0 = 0; t0 < steps; t0 += kTileSteps) {
    const int n = min(kTileSteps, len - t0);  // <= 0 once this lane is done
    tile::ClassWords<T> cls;
    cls.load(seg + t0, n);
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        const uint32_t v = lookup(table, s, cls.at(t), num_classes);
        row[t] = v >> state_bits;
        s = v & smask;
      }
    }
    __syncwarp();
    tile::store_tile(warp_tile, lane, dst + t0, n, vec, out);
    __syncwarp();  // the rows are rewritten by the next tile
  }
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types; window_bytes
// selects the uint8 or uint16 window instantiation.  `out` is one zeroed
// uint64 for the count, and uint32[num_windows * (width - halo)] for planes.
extern "C" int packed_scan_count(const void* table, const void* windows,
                                 int window_bytes, int64_t num_windows, int width,
                                 int halo, int num_classes, int state_bits,
                                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* total = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, total);
  } else if (window_bytes == 2) {
    count_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `segments` lanes per window, `seg_len` body positions each (the last one
// shorter): 1 and width - halo, or, when halo >= 1, segments in 2..4 and
// seg_len a multiple of 4 with (segments - 1) * seg_len < width - halo.
extern "C" int packed_scan_planes(const void* table, const void* windows,
                                  int window_bytes, int64_t num_windows, int width,
                                  int halo, int num_classes, int state_bits, int segments,
                                  int seg_len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int body = width - halo;
  const bool one = segments == 1 && seg_len == body;
  const bool split = segments >= 2 && segments <= 4 && halo >= 1 && seg_len % 4 == 0 &&
                     (segments - 1) * seg_len < body && segments * seg_len >= body;
  if (!one && !split) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* planes = static_cast<uint32_t*>(out);
  // Runs start at b*C + k*L + a multiple of 32: 16-byte aligned when C and
  // L are multiples of 4 and `out` is.
  const bool vec = body % 4 == 0 && seg_len % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  if (window_bytes == 1) {
    planes_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, segments, seg_len, vec, planes);
  } else if (window_bytes == 2) {
    planes_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, segments, seg_len, vec, planes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
