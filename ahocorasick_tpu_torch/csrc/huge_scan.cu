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
// What it computes.  Thread b scans window b of `width` classes: a warm-up
// from the root (state 0) over the `halo` left-context classes, then the
// body, C = width - halo positions (the automaton is halo-synchronizing, so
// the body sees the sequential automaton's states).  The hotstate plane runs
// K lanes per window instead, each warmed over the halo classes before its
// segment, as packed_scan.cu's planes kernel does.
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
// about 470 MB, far beyond the 50 MB L2.  Only the sectors of the states a
// text keeps visiting can stay in L2; every other step of a lane is a
// dependent load that waits on device memory.  At 32 Mi units in 512-class
// windows there are 65,536 windows, and one lane per window fills about a
// quarter of the 132 SMs x 2,048 resident threads: the scans are
// latency-bound.  The state lives in a register, the tables are read through
// the read-only path (__ldg), the flat index is 64-bit (S*A of the 1M
// dictionary is about 118 M entries, and the split tables may be larger),
// counts accumulate in 64-bit registers and are reduced in-warp and in-block
// with one 64-bit atomic per block, and each output word is written once.
// The hotstate plane is packed_scan.cu's planes lane (tile.cuh planes_lane)
// with the whole entry as its value: its first form, one lane per window
// storing 4 bytes a step at its own row of the output (the 32 lanes of a
// warp 2 KiB apart, a sector opened per store) and loading a class a step,
// took 0.855 ms at the 1M cell, the count-packed count over the same
// windows without stores about 0.45 ms.  Through the 16-byte store tile it
// took 0.536 ms and with word loads of the classes 0.427 ms; K = 2 lanes
// per window tied with K = 1 there, won at 32,768 windows, and K = 4 at
// 8,192, so the wrapper keeps the lanes within 65,536, the planes kernel's
// cap (python -m ahocorasick_tpu_torch.bench.scan_variants, NVIDIA H100
// 80GB HBM3, 700 W).
// Left for later work: the count-packed count and the split scans still run
// one lane per window with a class load a step, and the split planes store
// 4 bytes a lane at the row stride; a staged cache of the hot states.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

using tile::lookup;
using tile::warm_up;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packedcount_count_kernel(const uint32_t* __restrict__ table,
                             const T* __restrict__ windows, int64_t num_windows,
                             int width, int halo, uint32_t num_classes,
                             int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = warm_up(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; ++t) {
      const uint32_t v = lookup(table, s, row[t], num_classes);
      total += v >> state_bits;
      s = v & smask;
    }
  }
  tile::block_add<kThreads>(total, out);  // lanes past num_windows add 0
}

// The whole entry where a keyword ends, else 0: the hotstate plane's value
// per body position.
struct HotEntry {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_planes_kernel(const uint32_t* __restrict__ dfa,
                        const uint32_t* __restrict__ emit,
                        const T* __restrict__ windows, int64_t num_windows,
                        int width, int halo, uint32_t num_classes, int num_planes,
                        uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const int64_t body = width - halo;
  const int64_t plane_stride = num_windows * body;  // B*C
  uint32_t s = warm_up(dfa, row, halo, num_classes, 0xffffffffu);
  uint32_t* dst = out + b * body;
  for (int t = halo; t < width; ++t) {
    s = lookup(dfa, s, row[t], num_classes);
    const uint32_t* e = emit + static_cast<uint64_t>(s) * num_planes;
    for (int p = 0; p < num_planes; ++p) dst[p * plane_stride + (t - halo)] = __ldg(e + p);
  }
}

unsigned grid_for(int64_t num_windows) {
  return static_cast<unsigned>((num_windows + kThreads - 1) / kThreads);
}

// Every entry point returns cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types; window_bytes
// selects the uint8 or uint16 window instantiation.  `out` is one zeroed
// uint64 for a count, uint32[num_windows * (width - halo)] for the hotstate
// plane and uint32[num_planes * num_windows * (width - halo)] for the split
// planes.

template <typename T>
void launch_packedcount(bool count, const void* table, const void* windows,
                        int64_t num_windows, int width, int halo, int num_classes,
                        int state_bits, int segments, int seg_len, void* out,
                        cudaStream_t st) {
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* win = static_cast<const T*>(windows);
  const auto a = static_cast<uint32_t>(num_classes);
  if (count) {
    packedcount_count_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
        tab, win, num_windows, width, halo, a, state_bits,
        static_cast<unsigned long long*>(out));
  } else {
    auto* plane = static_cast<uint32_t*>(out);
    packedcount_hotstate_kernel<T><<<grid_for(num_windows * segments), kThreads, 0, st>>>(
        tab, win, num_windows, width, halo, a, state_bits, segments, seg_len,
        tile::vec_runs(width - halo, seg_len, plane), plane);
  }
}

template <typename T>
void launch_split(bool count, const void* dfa_flat, const void* emit_tab,
                  const void* windows, int64_t num_windows, int width, int halo,
                  int num_classes, int num_planes, void* out, cudaStream_t st) {
  const auto* dfa = static_cast<const uint32_t*>(dfa_flat);
  const auto* emit = static_cast<const uint32_t*>(emit_tab);
  const auto* win = static_cast<const T*>(windows);
  const auto a = static_cast<uint32_t>(num_classes);
  if (count) {
    split_count_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
        dfa, emit, win, num_windows, width, halo, a, num_planes,
        static_cast<unsigned long long*>(out));
  } else {
    split_planes_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
        dfa, emit, win, num_windows, width, halo, a, num_planes,
        static_cast<uint32_t*>(out));
  }
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

int split_entry(bool count, const void* dfa_flat, const void* emit_tab,
                const void* windows, int window_bytes, int64_t num_windows,
                int width, int halo, int num_classes, int num_planes, void* out,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    launch_split<uint8_t>(count, dfa_flat, emit_tab, windows, num_windows, width,
                          halo, num_classes, num_planes, out, st);
  } else if (window_bytes == 2) {
    launch_split<uint16_t>(count, dfa_flat, emit_tab, windows, num_windows, width,
                           halo, num_classes, num_planes, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int packedcount_count(const void* table, const void* windows,
                                 int window_bytes, int64_t num_windows, int width,
                                 int halo, int num_classes, int state_bits,
                                 void* out, int device, void* stream) {
  const int body = width - halo;
  return packedcount_entry(true, table, windows, window_bytes, num_windows, width,
                           halo, num_classes, state_bits, 1, body, out, device, stream);
}

// `segments` lanes per window, `seg_len` body positions each
// (tile::valid_segments).
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
  return split_entry(true, dfa_flat, emit_tab, windows, window_bytes, num_windows,
                     width, halo, num_classes, num_planes, out, device, stream);
}

extern "C" int split_emit_planes(const void* dfa_flat, const void* emit_tab,
                                 const void* windows, int window_bytes,
                                 int64_t num_windows, int width, int halo,
                                 int num_classes, int num_planes, void* out,
                                 int device, void* stream) {
  return split_entry(false, dfa_flat, emit_tab, windows, window_bytes, num_windows,
                     width, halo, num_classes, num_planes, out, device, stream);
}
