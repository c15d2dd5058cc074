// Huge-dictionary lane scans for Hopper (sm_90a): the count-packed count, the
// hotstate plane, and the split count and emit planes, behind a plain C
// interface loaded with ctypes (ahocorasick_tpu_torch/kernels/build.py builds
// it, kernels/scan_batched.py binds it).
//
// What it replaces.  The JAX device loops of ahocorasick_tpu/ops/
// scan_batched.py for dictionaries whose state bits plus max depth exceed 32
// (the emit mask does not fit beside the state): packedcount_count (:190),
// packedcount_hotstate_plane (:237), split_emit_planes (:417) and split_count
// (:460).  Each entry point keeps the name of the loop it replaces.
//
// What it computes.  A window of `width` classes is `halo` left-context
// classes and C = width - halo body classes.  The count-packed count, the
// hotstate plane and the split planes run K lanes per window, as
// packed_scan.cu's kernels do: segment k covers body positions [k*L,
// min((k+1)*L, C)) and is warmed from the root (state 0) over the `halo`
// classes just before it, which is exact because the automaton is
// halo-synchronizing (the wrapper fixes K and L, kernels/scan_block.py
// segments, each kernel under its own cap on lanes; the plain twins take the
// same decomposition).  The split count runs one lane per window.
// - Count-packed table, flat uint32[S*A]: entry s*A + c is
//   next | emit_count(next) << state_bits.  packedcount_count sums
//   emit_count (the number of keywords ending there, not a popcount) over
//   the body; packedcount_hotstate_plane writes the whole entry v to
//   out[b*C + j] where v >> state_bits != 0, and 0 elsewhere (flat text
//   order).  The host decodes the emit masks from the state in v.
// - Split tables: dfa_flat uint32[S*A] holds the bare next state (no mask:
//   all 32 bits are state), emit_tab uint32[S*P] the state's P emit planes.
//   split_count sums popcount(emit_tab[next*P + p]) over the planes;
//   split_emit_planes writes plane p of body position j of window b to
//   out[p*B*C + b*C + j] (plane-major, flat text order within a plane).
//
// What bounds it on the H100.  Every character is one table load whose
// address depends on the previous load (s -> s*A + c), plus P emit loads on
// the split path.  These tables are large by construction: the 1M-keyword
// dictionary's count-packed table is 4,356,756 states x 27 classes x 4 B,
// about 470 MB (its split tables the same plus 17 MB of emit planes), far
// beyond the 50 MB L2.  Only the sectors of the states a text keeps
// visiting can stay in L2; every other step of a lane is a dependent load
// that waits on device memory.  The byte bound (windows in; a count, or 4 B
// per body position and plane out) at the main path's 65,536 windows of
// 12 + 512 classes is 0.010 ms for the counts and 0.050 ms a plane: the
// kernels are latency chains, about 800 ns a step with one lane a window.
// The state lives in a register, the tables are read through the read-only
// path (__ldg), the flat index is 64-bit (S*A of the 1M dictionary is about
// 118 M entries, and the split tables may be larger), counts accumulate in
// 64-bit registers and are reduced in-warp and in-block with one 64-bit
// atomic per block, and each output word is written once.  What the design
// does about the chains (tile.cuh):
//   * No class load in the chain.  The count-packed count is the count lane
//     (tile.cuh count_lane, packed_scan.cu's count with the emit count as
//     its value): a lane reads its classes a 32-bit word at a time into a
//     32-step register tile.  The planes kernels read a 16-step tile the
//     same way.  Its first form, one lane per window loading a byte a step,
//     took 0.452 ms at the 1M cell; the hotstate plane, the same walk with
//     word loads and stores besides, 0.427 ms.
//   * Coalesced stores through shared memory.  The hotstate plane and the
//     split planes are the planes lane (tile.cuh planes_lane): each lane
//     writes a 16-step tile of values into its own shared-memory row, and
//     the warp stores each lane's run as whole sectors.  Their first forms
//     stored 4 bytes a lane a step at the lane's own row of the output (the
//     32 lanes of a warp 2 KiB apart, a sector opened per store): the
//     hotstate plane took 0.855 ms that way and 0.427 ms through the tile;
//     the split planes 1.156 ms.
//   * The split planes' emit loads out of the chain.  A lane keeps its
//     tile's 16 states in registers and loads their planes after the
//     tile's lookups, 16 independent loads at a time, so no lookup waits on
//     an emit load.  A block holds the tiles of up to 13 planes (17,408 B
//     each at 256 threads; 227 KB of dynamic shared memory); deeper
//     dictionaries run further groups of 13 planes as more blocks, each
//     rescanning its segment.
//   * K lanes per window where windows are few, so each chain is shorter.
//     At 65,536 windows one lane per window fills about a quarter of the
//     132 SMs x 2,048 resident threads; the caps on lanes are the A/B's
//     (python -m ahocorasick_tpu_torch.bench.scan_variants, beside the caps
//     in kernels/scan_batched.py).
// Left for later work: the split count still runs one lane per window with
// a class load a step (the count lane with the value sum over p of
// popcount(emit_tab[s*P + p]) applies); a staged cache of the hot states.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
// The split planes' tiles of one plane, and the planes a block holds: the
// card's 227 KB (232,448 B) of shared memory a block over one plane's
// 256 x 17 words.
constexpr int kPlaneTileBytes = kThreads * tile::kPitch * 4;
constexpr int kMaxGroupPlanes = 232448 / kPlaneTileBytes;  // 13
constexpr int kStaticSharedBytes = 48 * 1024;  // beyond it, opt in per kernel

using tile::lookup;
using tile::warm_up;

// The number of keywords that end at an entry, the count-packed count's
// value.  It may take all 32 - state_bits bits, so the lane adds it in 64.
struct EmitCount {
  int state_bits;
  __device__ __forceinline__ unsigned long long operator()(uint32_t v) const {
    return v >> state_bits;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packedcount_count_kernel(const uint32_t* __restrict__ table,
                             const T* __restrict__ windows, int64_t num_windows,
                             int width, int halo, uint32_t num_classes,
                             int state_bits, int segments, int seg_len,
                             unsigned long long* __restrict__ out) {
  const unsigned long long total = tile::count_lane<unsigned long long>(
      table, windows, num_windows, width, halo, num_classes, (1u << state_bits) - 1u, segments,
      seg_len, EmitCount{state_bits});
  tile::block_add<kThreads>(total, out);  // lanes past the last window add 0
}

// The whole entry where a keyword ends, else 0: the hotstate plane's value
// per body position.
struct HotEntry {
  static constexpr bool kGather = false;
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return (v >> state_bits) != 0u ? v : 0u;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packedcount_hotstate_kernel(const uint32_t* __restrict__ table,
                                const T* __restrict__ windows, int64_t num_windows,
                                int width, int halo, uint32_t num_classes,
                                int state_bits, int segments, int seg_len, bool vec,
                                uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  tile::planes_lane<tile::ClassWords<T>>(table, windows, num_windows, width, halo,
                                         num_classes, (1u << state_bits) - 1u, segments,
                                         seg_len, vec, tiles, out, HotEntry{state_bits});
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_count_kernel(const uint32_t* __restrict__ dfa,
                       const uint32_t* __restrict__ emit,
                       const T* __restrict__ windows, int64_t num_windows,
                       int width, int halo, uint32_t num_classes, int num_planes,
                       unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    uint32_t s = warm_up(dfa, row, halo, num_classes, 0xffffffffu);
    for (int t = halo; t < width; ++t) {
      s = lookup(dfa, s, row[t], num_classes);
      const uint32_t* e = emit + static_cast<uint64_t>(s) * num_planes;
      for (int p = 0; p < num_planes; ++p) total += __popc(__ldg(e + p));
    }
  }
  tile::block_add<kThreads>(total, out);
}

// Planes first .. first + count - 1 of a state's emit_tab row, the split
// planes' values (loads, so the lane gathers them after a tile's lookups).
struct EmitPlanes {
  static constexpr bool kGather = true;
  const uint32_t* emit;
  int num_planes, first, count;
  __device__ __forceinline__ int planes() const { return count; }
  __device__ __forceinline__ uint32_t operator()(uint32_t s, int p) const {
    return __ldg(emit + static_cast<uint64_t>(s) * num_planes + first + p);
  }
};

// Block (x, y) scans lanes x*kThreads.. for planes y*group .. y*group +
// group - 1 (fewer in the last group); its dynamic shared memory holds
// `group` plane tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_planes_kernel(const uint32_t* __restrict__ dfa,
                        const uint32_t* __restrict__ emit,
                        const T* __restrict__ windows, int64_t num_windows,
                        int width, int halo, uint32_t num_classes, int num_planes,
                        int group, int segments, int seg_len, bool vec,
                        uint32_t* __restrict__ out) {
  extern __shared__ uint32_t tiles[];
  const int first = static_cast<int>(blockIdx.y) * group;
  const int64_t plane_stride = num_windows * (width - halo);
  tile::planes_lane<tile::ClassWords<T>>(
      dfa, windows, num_windows, width, halo, num_classes, 0xffffffffu, segments, seg_len, vec,
      tiles, out + first * plane_stride,
      EmitPlanes{emit, num_planes, first, min(group, num_planes - first)});
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// Every entry point returns cudaGetLastError() after the launch (0 = the
// launch was accepted), or the error of a refused shared-memory opt-in.  The
// caller validates shapes and types; window_bytes selects the uint8 or
// uint16 window instantiation.  `segments` lanes per window, `seg_len` body
// positions each (tile::valid_segments).  `out` is one zeroed uint64 for a
// count, uint32[num_windows * (width - halo)] for the hotstate plane and
// uint32[num_planes * num_windows * (width - halo)] for the split planes.

template <typename T>
void launch_packedcount(bool count, const void* table, const void* windows,
                        int64_t num_windows, int width, int halo, int num_classes,
                        int state_bits, int segments, int seg_len, void* out,
                        cudaStream_t st) {
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* win = static_cast<const T*>(windows);
  const auto a = static_cast<uint32_t>(num_classes);
  const unsigned grid = grid_for(num_windows * segments);
  if (count) {
    packedcount_count_kernel<T><<<grid, kThreads, 0, st>>>(
        tab, win, num_windows, width, halo, a, state_bits, segments, seg_len,
        static_cast<unsigned long long*>(out));
  } else {
    auto* plane = static_cast<uint32_t*>(out);
    packedcount_hotstate_kernel<T><<<grid, kThreads, 0, st>>>(
        tab, win, num_windows, width, halo, a, state_bits, segments, seg_len,
        tile::vec_runs(width - halo, seg_len, plane), plane);
  }
}

template <typename T>
cudaError_t launch_split_planes(const uint32_t* dfa, const uint32_t* emit, const void* windows,
                                int64_t num_windows, int width, int halo, uint32_t a,
                                int num_planes, int segments, int seg_len, uint32_t* out,
                                cudaStream_t st) {
  const int group = min(num_planes, kMaxGroupPlanes);
  const int groups = (num_planes + group - 1) / group;
  const int smem = group * kPlaneTileBytes;
  if (smem > kStaticSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_planes_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  split_planes_kernel<T><<<dim3(grid_for(num_windows * segments), groups), kThreads, smem, st>>>(
      dfa, emit, static_cast<const T*>(windows), num_windows, width, halo, a, num_planes, group,
      segments, seg_len, tile::vec_runs(width - halo, seg_len, out), out);
  return cudaSuccess;
}

int packedcount_entry(bool count, const void* table, const void* windows,
                      int window_bytes, int64_t num_windows, int width, int halo,
                      int num_classes, int state_bits, int segments, int seg_len, void* out,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    launch_packedcount<uint8_t>(count, table, windows, num_windows, width, halo,
                                num_classes, state_bits, segments, seg_len, out, st);
  } else if (window_bytes == 2) {
    launch_packedcount<uint16_t>(count, table, windows, num_windows, width, halo,
                                 num_classes, state_bits, segments, seg_len, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int packedcount_count(const void* table, const void* windows,
                                 int window_bytes, int64_t num_windows, int width,
                                 int halo, int num_classes, int state_bits, int segments,
                                 int seg_len, void* out, int device, void* stream) {
  return packedcount_entry(true, table, windows, window_bytes, num_windows, width, halo,
                           num_classes, state_bits, segments, seg_len, out, device, stream);
}

extern "C" int packedcount_hotstate_plane(const void* table, const void* windows,
                                          int window_bytes, int64_t num_windows,
                                          int width, int halo, int num_classes,
                                          int state_bits, int segments, int seg_len,
                                          void* out, int device, void* stream) {
  return packedcount_entry(false, table, windows, window_bytes, num_windows, width,
                           halo, num_classes, state_bits, segments, seg_len, out, device,
                           stream);
}

extern "C" int split_count(const void* dfa_flat, const void* emit_tab,
                           const void* windows, int window_bytes,
                           int64_t num_windows, int width, int halo,
                           int num_classes, int num_planes, void* out, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* dfa = static_cast<const uint32_t*>(dfa_flat);
  const auto* emit = static_cast<const uint32_t*>(emit_tab);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* total = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    split_count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, static_cast<const uint8_t*>(windows), num_windows, width, halo, a,
        num_planes, total);
  } else if (window_bytes == 2) {
    split_count_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, static_cast<const uint16_t*>(windows), num_windows, width, halo, a,
        num_planes, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int split_emit_planes(const void* dfa_flat, const void* emit_tab,
                                 const void* windows, int window_bytes,
                                 int64_t num_windows, int width, int halo,
                                 int num_classes, int num_planes, int segments, int seg_len,
                                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_planes < 1 || !tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* dfa = static_cast<const uint32_t*>(dfa_flat);
  const auto* emit = static_cast<const uint32_t*>(emit_tab);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* planes = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    err = launch_split_planes<uint8_t>(dfa, emit, windows, num_windows, width, halo, a,
                                       num_planes, segments, seg_len, planes, st);
  } else if (window_bytes == 2) {
    err = launch_split_planes<uint16_t>(dfa, emit, windows, num_windows, width, halo, a,
                                        num_planes, segments, seg_len, planes, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
