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
// prefix, at most max_depth long.  Both kernels run K lanes per window:
// segment k covers body positions [k*L, min((k+1)*L, C)) and is warmed from
// the root over the `halo` classes just before it in the same row (the
// row's own halo for k = 0, body classes for k > 0).  The wrapper fixes K
// and L (kernels/scan_block.py segments, each kernel with its own cap on
// lanes): K = 4, 2 or 1, the largest that keeps B*K within the cap and
// whose segments are at least four halos and 32 steps long, L a multiple
// of 4; K = 1 when halo = 0, where nothing synchronizes.  The plain twins
// take the same decomposition.
//
// What bounds it on the H100.  Every character is one table load whose
// address depends on the previous load (s -> s*A + c): a lane is a chain of
// dependent loads.  The main path's table (10k keywords: 50,352 states x 32
// classes x 4 B = 6.4 MB) is too big for a block's 227 KB of shared memory
// and is read through L1 and the 50 MB L2.  The byte bound (windows in, and
// 4 B per body position out for the planes) at the main path's 65,536
// windows of 12 + 512 classes is 0.010 ms for the count and 0.050 ms for the
// planes.  The kernels stay far from it because a lane waits on each lookup:
// at 8,192 and at 65,536 windows one lane per window took the same time
// (python -m ahocorasick_tpu_torch.bench.scan_variants), about 200 ns a
// step, an L2 round trip, so the time is the chain's length times the
// latency until there are enough chains to fill the caches' rate.  What
// this design does about it:
//   * More lanes per window, so each chain is shorter.  The count (no store
//     tile) takes K lanes while B*K stays within 131,072, the planes kernel
//     within 65,536 (its store tile and stores crowd L1 sooner): at the main
//     path's 65,536 windows the count runs K = 2 (0.073 ms against 0.105 at
//     K = 1 and 0.093 at K = 4), the planes kernel K = 1; at 8,192 windows
//     both run K = 4, the count 2.2-3.2x and the planes 3.4x faster than
//     one lane per window.  Two chains interleaved in one thread ran slower
//     than two threads (bench/scan_variants.cu keeps that count).
//   * Classes read a word at a time.  A lane loads the aligned 32-bit words
//     that hold its next tile of classes (4 uint8 or 2 uint16 classes a
//     load; a 32-step register tile for the count, 16 for the planes) and
//     funnel-shifts them into place, so no class load sits in the chain and
//     the lane's window stays in registers, leaving L1 to the table's hot
//     rows.  One lane per window with byte loads ran the count in 0.131 ms,
//     with word loads in 0.105 ms.
//   * Coalesced stores through shared memory (planes).  Each lane writes the
//     emit words of a tile of kTileSteps = 16 body steps into its own row of
//     a shared-memory tile, padded to 17 words so the 32 lanes' writes of one
//     step fall in 32 banks (68 B a lane: 2,048 lanes fit an SM; a 32-step
//     tile's 132 B allow 1,536 and ran slower).  After a __syncwarp the warp
//     stores each lane's contiguous 64-byte run with 16-byte stores, 4 lanes
//     per run, so every sector is full.  Where C or L is not a multiple of 4
//     (a run would not be 16-byte aligned) the runs go out as 4-byte stores,
//     16 lanes per run, still whole sectors.  (A TMA bulk store of each
//     lane's run, committed while the next tile is scanned, measured no
//     faster: bench/planes_stores.cu keeps it.)
// The state lives in a register, the table is read through the read-only
// path (__ldg), the flat index is 64-bit, and the count reduces in-warp and
// in-block with one 64-bit atomic per block.  The lane loops of both kernels
// (tile.cuh count_lane and planes_lane), the word loads and the store tile
// live in tile.cuh: huge_scan.cu's count-packed count runs the count lane,
// its hotstate plane and split emit planes the planes lane, and wwl_scan.cu's
// plane kernel the word loads and the store tile.  Left for later work: the
// sibling planes kernels that still store 4 bytes per lane at the row stride
// and load a class a step (rowdfa2_scan.cu's stride-2 planes,
// table_sharded.cu's row-sharded planes); small tables are not staged in
// shared memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

// The emit mask of an entry, the planes kernel's value per body position.
struct EmitMask {
  static constexpr bool kGather = false;
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const { return v >> state_bits; }
};

// The number of keywords that end at an entry, the count's value.
struct EmitPopcount {
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return __popc(v >> state_bits);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, uint32_t num_classes,
                 int state_bits, int segments, int seg_len,
                 unsigned long long* __restrict__ out) {
  // A tile's sum is at most 32 x 32 popcounts: 32 bits hold it.
  const unsigned long long pop = tile::count_lane<uint32_t>(
      table, windows, num_windows, width, halo, num_classes, (1u << state_bits) - 1u, segments,
      seg_len, EmitPopcount{state_bits});
  tile::block_add<kThreads>(pop, out);  // lanes past the last window add 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, int segments, int seg_len, bool vec,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  tile::planes_lane<tile::ClassWords<T>>(table, windows, num_windows, width, halo,
                                         num_classes, (1u << state_bits) - 1u, segments,
                                         seg_len, vec, tiles, out, EmitMask{state_bits});
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types; window_bytes
// selects the uint8 or uint16 window instantiation.  `segments` lanes per
// window, `seg_len` body positions each (tile::valid_segments).  `out` is
// one zeroed uint64 for the count, and uint32[num_windows * (width - halo)]
// for planes.
extern "C" int packed_scan_count(const void* table, const void* windows,
                                 int window_bytes, int64_t num_windows, int width,
                                 int halo, int num_classes, int state_bits, int segments,
                                 int seg_len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* total = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  const auto a = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, a, state_bits,
        segments, seg_len, total);
  } else if (window_bytes == 2) {
    count_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, a, state_bits,
        segments, seg_len, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_scan_planes(const void* table, const void* windows,
                                  int window_bytes, int64_t num_windows, int width,
                                  int halo, int num_classes, int state_bits, int segments,
                                  int seg_len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int body = width - halo;
  if (!tile::valid_segments(segments, seg_len, body, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* planes = static_cast<uint32_t*>(out);
  const bool vec = tile::vec_runs(body, seg_len, planes);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  const auto a = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    planes_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, a, state_bits,
        segments, seg_len, vec, planes);
  } else if (window_bytes == 2) {
    planes_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, a, state_bits,
        segments, seg_len, vec, planes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
