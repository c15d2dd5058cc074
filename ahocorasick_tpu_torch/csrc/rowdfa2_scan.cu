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
// mask after c0 alone).  A lane scans a window (planes) or a segment of one
// (count): from the root (state 0) it warms up over the even `halo` classes
// before its body, pair by pair, keeping the state only, then steps over the
// body pair by pair.  The count kernel sums
// popcount(emit1) + popcount(emit2); the planes kernel writes emit1 to body
// position 2t and emit2 to 2t + 1 of out[b*C ...], C = W - halo, which is
// flat text order, the layout of packed_scan_planes.
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
// The count is the count lane of packed_scan.cu with a pair a step:
//   * K lanes per window, so each chain is shorter: segment k covers body
//     positions [k*L, min((k+1)*L, C)) and is warmed from the root over the
//     `halo` classes before it (the automaton is halo-synchronizing).  L is
//     a multiple of 4 and the halo even, so every segment starts on a pair
//     of the one-lane scan and reads the same pairs.  The wrapper fixes K
//     and L (kernels/scan_block.py segments under the stride-2 count's own
//     cap, kernels/scan_rowdfa.py ROWDFA2_COUNT_MAX_LANES, set by the A/B of
//     bench/scan_variants.py); the twin takes the same decomposition.
//   * Classes read a word at a time: a lane loads the aligned 32-bit words
//     that hold its next 32 classes (16 pairs) into registers (tile.cuh
//     ClassWords), so no class load sits in the chain.
//   * A tile's popcounts add up in 32 bits, the lane's in 64, and the block's
//     lanes in one 64-bit atomic (tile.cuh block_add).
// The planes kernel keeps its first design: one lane per window, a class
// load a step, and each pair stored as one 8-byte word at the lane's own row
// (left for later work: the planes lane of tile.cuh).  The count's first
// design, one lane per window with a class load a step, took 0.200 ms at the
// 10k dictionary's 65,536 x 524 windows on an H100 (bench/scan_variants.cu
// keeps it).

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

// The word of row (s, c0), column col: table[(s*A + c0)*(A + 1) + col].
__device__ __forceinline__ uint64_t row_base(uint32_t s, uint32_t c0, uint32_t num_classes) {
  return (static_cast<uint64_t>(s) * num_classes + c0) * (num_classes + 1u);
}

template <typename T>
__device__ __forceinline__ uint32_t warm_up2(const uint32_t* __restrict__ table,
                                             const T* __restrict__ row, int halo,
                                             uint32_t num_classes, uint32_t smask) {
  uint32_t s = 0;  // the root (compiler invariant)
  for (int t = 0; t < halo; t += 2) {
    s = __ldg(table + row_base(s, row[t], num_classes) + row[t + 1]) & smask;
  }
  return s;
}

// Lane g (the thread's global index) of a grid of num_windows * segments
// lanes: the popcounts of emit1 and emit2 over the pairs of its segment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    count2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, int segments, int seg_len,
                  unsigned long long* __restrict__ out) {
  constexpr int kSteps = tile::kCountSteps;  // classes a tile: 16 pairs
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const tile::Segment sg = tile::segment_of(g, num_windows, width, halo, segments, seg_len);
  const T* seg = windows + sg.b * width + sg.start;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = sg.len > 0 ? warm_up2(table, seg, halo, num_classes, smask) : 0u;
  seg += halo;
  unsigned long long total = 0;
  for (int t0 = 0; t0 < sg.len; t0 += kSteps) {
    const int n = min(kSteps, sg.len - t0);  // even: the segment and the tiles are
    tile::ClassWords<T, kSteps> cls;
    cls.load(seg + t0, n);
    uint32_t pop = 0;  // at most 32 popcounts of 31 bits
#pragma unroll
    for (int t = 0; t < kSteps; t += 2) {
      if (t < n) {
        const uint32_t* r = table + row_base(s, cls.at(t), num_classes);
        const uint32_t w = __ldg(r + cls.at(t + 1));
        const uint32_t e1 = __ldg(r + num_classes);
        pop += __popc(w >> state_bits) + __popc(e1);
        s = w & smask;
      }
    }
    total += pop;
  }
  tile::block_add<kThreads>(total, out);  // lanes past the last window add 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    planes2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                   int64_t num_windows, int width, int halo, uint32_t num_classes,
                   int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = warm_up2(table, row, halo, num_classes, smask);
  // C and the body offset are even, so each pair is an aligned 8-byte word.
  uint2* dst = reinterpret_cast<uint2*>(out + b * (width - halo));
  for (int t = halo; t < width; t += 2) {
    const uint32_t* r = table + row_base(s, row[t], num_classes);
    const uint32_t w = __ldg(r + row[t + 1]);
    const uint32_t e1 = __ldg(r + num_classes);
    dst[(t - halo) >> 1] = make_uint2(e1, w >> state_bits);
    s = w & smask;
  }
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// Launches Launch<T> over num_windows * segments lanes, segment_len body
// positions each (tile.cuh valid_segments; the planes kernel runs 1 and C).
template <typename Out, template <typename> class Launch>
int launch(const void* table, const void* windows, int window_bytes, int64_t num_windows,
           int width, int halo, int num_classes, int state_bits, int segments, int seg_len,
           void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (halo % 2 != 0 || (width - halo) % 2 != 0 ||
      !tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* dst = static_cast<Out*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  const auto a = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    Launch<uint8_t>::run(grid, st, tab, static_cast<const uint8_t*>(windows), num_windows,
                         width, halo, a, state_bits, segments, seg_len, dst);
  } else if (window_bytes == 2) {
    Launch<uint16_t>::run(grid, st, tab, static_cast<const uint16_t*>(windows), num_windows,
                          width, halo, a, state_bits, segments, seg_len, dst);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct Count2 {
  static void run(unsigned grid, cudaStream_t st, const uint32_t* tab, const T* w, int64_t n,
                  int width, int halo, uint32_t a, int sb, int k, int seg_len,
                  unsigned long long* out) {
    count2_kernel<T><<<grid, kThreads, 0, st>>>(tab, w, n, width, halo, a, sb, k, seg_len, out);
  }
};

template <typename T>
struct Planes2 {
  static void run(unsigned grid, cudaStream_t st, const uint32_t* tab, const T* w, int64_t n,
                  int width, int halo, uint32_t a, int sb, int, int, uint32_t* out) {
    planes2_kernel<T><<<grid, kThreads, 0, st>>>(tab, w, n, width, halo, a, sb, out);
  }
};

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted), or cudaErrorInvalidValue for an odd halo or body or
// segments that tile.cuh valid_segments refuses.  The caller validates
// shapes and types; window_bytes selects the uint8 or uint16 window
// instantiation.  `out` is one zeroed uint64 for the count (K = `segments`
// lanes per window of `seg_len` body positions), and uint32[num_windows *
// (width - halo)] for planes (one lane per window).
extern "C" int rowdfa2_count(const void* table, const void* windows, int window_bytes,
                             int64_t num_windows, int width, int halo, int num_classes,
                             int state_bits, int segments, int seg_len, void* out, int device,
                             void* stream) {
  return launch<unsigned long long, Count2>(table, windows, window_bytes, num_windows, width,
                                            halo, num_classes, state_bits, segments, seg_len,
                                            out, device, stream);
}

extern "C" int rowdfa2_planes(const void* table, const void* windows, int window_bytes,
                              int64_t num_windows, int width, int halo, int num_classes,
                              int state_bits, void* out, int device, void* stream) {
  return launch<uint32_t, Planes2>(table, windows, window_bytes, num_windows, width, halo,
                                   num_classes, state_bits, 1, width - halo, out, device,
                                   stream);
}
