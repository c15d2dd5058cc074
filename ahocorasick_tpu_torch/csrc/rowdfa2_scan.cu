// Stride-2 row-DFA lane scan for Hopper (sm_90a): match count and
// END-indexed emit planes, two characters per dependent table load, behind a
// plain C interface loaded with ctypes (ahocorasick_tpu_torch/kernels/build.py
// builds it, kernels/scan_rowdfa.py binds it).
//
// What it replaces.  The stride-2 XLA lane scans of the JAX package,
// ahocorasick_tpu/ops/scan_rowdfa.py rowdfa_count (:248) and
// rowdfa_emit_planes (:286), which gather row s*A + c0 of the table and
// select column c1 with a one-hot reduce.
//
// What it computes.  The table (ops/scan_rowdfa.build_rowdfa) has A + 1
// columns per row (s, c0): column c1 < A holds  state2 | emit2 << state_bits
// (the state and emit mask after c0 then c1), column A holds emit1 (the emit
// mask after c0 alone).  Both kernels run K lanes per window: segment k
// covers body positions [k*L, min((k+1)*L, C)) of the window's C = W - halo
// and is warmed from the root (state 0) over the `halo` classes before it,
// pair by pair, keeping the state only (the automaton is halo-synchronizing).
// L is a multiple of 4 and the halo and C even, so every segment starts on a
// pair of the one-lane scan and reads the same pairs.  The wrapper fixes K
// and L (kernels/scan_block.py segments under each kernel's own cap,
// kernels/scan_rowdfa.py ROWDFA2_COUNT_MAX_LANES and
// ROWDFA2_PLANES_MAX_LANES, set by the A/B of bench/scan_variants.py); the
// twins take the same decomposition.  The count sums popcount(emit1) +
// popcount(emit2); the planes kernel writes emit1 to body position 2t and
// emit2 to 2t + 1 of out[b*C ...], which is flat text order, the layout of
// packed_scan_planes.
//
// What bounds it on the H100.  As for the packed scan (packed_scan.cu), each
// lane is a chain of dependent loads whose address depends on the previous
// load's result: a lane waits on L2 (or, for a table past the 50 MB L2, on
// device memory) each step, with a byte bound of the windows in (and 4 B per
// position out for planes) far below.  The stride-2 table halves the chain
// to C/2 dependent loads per window: the two loads of a step (column c1 and
// column A of the same row) are independent and issued together, so a step
// costs one round trip.  The price is the table's size, S*A*(A+1)*4 B
// (152 MB for the 10k dictionary), so many steps wait on device memory
// (ops/scan_rowdfa.pick_engine gives the measured timings).  The flat index
// is 64-bit (a 10k-keyword table has 38 M entries, a forced one up to 2^28).
//
// Both kernels are tile.cuh's lane loops over its stride-2 table type
// (tile::Stride2: a step consumes a pair of classes and reads w and emit1
// from one row), so what the other scans' design does holds here:
//   * K lanes per window, so each chain is shorter.
//   * Classes read a word at a time: a lane loads the aligned 32-bit words
//     that hold its next 32 classes (16 pairs; the planes lane 16 classes, 8
//     pairs) into registers (tile.cuh ClassWords), so no class load sits in
//     the chain.
//   * The count: a tile's popcounts add up in 32 bits, the lane's in 64, and
//     the block's lanes in one 64-bit atomic (tile.cuh count_lane and
//     block_add).
//   * The planes: a lane writes each pair's two words into its row of the
//     warp's 16-step store tile in shared memory, and the warp stores each
//     lane's run as whole sectors (tile.cuh planes_lane and store_tile).
// The first designs, one lane per window with a class load a step (and, for
// the planes, each pair stored as one 8-byte word at the lane's own row, the
// 32 lanes of a warp 1 KiB apart), took 0.200 ms (count) and 0.483 ms
// (planes) at the 10k dictionary's 65,536 x 524 windows on an H100
// (bench/scan_variants.cu keeps both).

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

// popcount(emit1) + popcount(emit2) of a step, the count's value.  A tile's
// sum is at most 16 x 62 bits: 32 bits hold it.
struct PairPopcount {
  static constexpr bool kGather = false;
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(tile::Pair p) const {
    return __popc(p.w >> state_bits) + __popc(p.e1);
  }
};

// The emit masks of a step's two positions, the planes' values: emit1, then
// emit2.
struct PairEmits {
  static constexpr bool kGather = false;
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(tile::Pair p, int i) const {
    return i == 0 ? p.e1 : p.w >> state_bits;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, int segments, int seg_len,
                  unsigned long long* __restrict__ out) {
  const unsigned long long total = tile::count_lane<uint32_t>(
      tile::Stride2{table, num_classes}, windows, num_windows, width, halo,
      (1u << state_bits) - 1u, segments, seg_len, PairPopcount{state_bits});
  tile::block_add<kThreads>(total, out);  // lanes past the last window add 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    planes2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                   int64_t num_windows, int width, int halo, uint32_t num_classes,
                   int state_bits, int segments, int seg_len, bool vec,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  tile::planes_lane<tile::ClassWords<T>>(tile::Stride2{table, num_classes}, windows,
                                         num_windows, width, halo, (1u << state_bits) - 1u,
                                         segments, seg_len, vec, tiles, out,
                                         PairEmits{state_bits});
}

// Launches the count (`count`) or the planes kernel over num_windows *
// segments lanes, seg_len body positions each (tile.cuh valid_segments).
template <typename T>
void launch_kernel(bool count, cudaStream_t st, const uint32_t* table, const void* windows,
                   int64_t num_windows, int width, int halo, uint32_t num_classes,
                   int state_bits, int segments, int seg_len, void* out) {
  const auto grid = static_cast<unsigned>((num_windows * segments + kThreads - 1) / kThreads);
  const auto* w = static_cast<const T*>(windows);
  if (count) {
    count2_kernel<T><<<grid, kThreads, 0, st>>>(table, w, num_windows, width, halo,
                                                num_classes, state_bits, segments, seg_len,
                                                static_cast<unsigned long long*>(out));
  } else {
    auto* planes = static_cast<uint32_t*>(out);
    planes2_kernel<T><<<grid, kThreads, 0, st>>>(table, w, num_windows, width, halo,
                                                 num_classes, state_bits, segments, seg_len,
                                                 tile::vec_runs(width - halo, seg_len, planes),
                                                 planes);
  }
}

int launch(bool count, const void* table, const void* windows, int window_bytes,
           int64_t num_windows, int width, int halo, int num_classes, int state_bits,
           int segments, int seg_len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (halo % 2 != 0 || (width - halo) % 2 != 0 ||
      !tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    launch_kernel<uint8_t>(count, st, tab, windows, num_windows, width, halo, a, state_bits,
                           segments, seg_len, out);
  } else if (window_bytes == 2) {
    launch_kernel<uint16_t>(count, st, tab, windows, num_windows, width, halo, a, state_bits,
                            segments, seg_len, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted), or cudaErrorInvalidValue for an odd halo or body or
// segments that tile.cuh valid_segments refuses.  The caller validates
// shapes and types; window_bytes selects the uint8 or uint16 window
// instantiation.  K = `segments` lanes per window of `seg_len` body
// positions.  `out` is one zeroed uint64 for the count, and
// uint32[num_windows * (width - halo)] for planes.
extern "C" int rowdfa2_count(const void* table, const void* windows, int window_bytes,
                             int64_t num_windows, int width, int halo, int num_classes,
                             int state_bits, int segments, int seg_len, void* out, int device,
                             void* stream) {
  return launch(true, table, windows, window_bytes, num_windows, width, halo, num_classes,
                state_bits, segments, seg_len, out, device, stream);
}

extern "C" int rowdfa2_planes(const void* table, const void* windows, int window_bytes,
                              int64_t num_windows, int width, int halo, int num_classes,
                              int state_bits, int segments, int seg_len, void* out, int device,
                              void* stream) {
  return launch(false, table, windows, window_bytes, num_windows, width, halo, num_classes,
                state_bits, segments, seg_len, out, device, stream);
}
