// Designs of the count kernel and of the hotstate plane that the package
// does not use, kept so that python -m ahocorasick_tpu_torch.bench.scan_variants
// can time them beside csrc/packed_scan.cu's packed_scan_count and
// csrc/huge_scan.cu's packedcount_hotstate_plane on the card.
//
// Each computes exactly the package's function (the same table contract; see
// the source notes of those files) and differs in how a lane reads its
// classes, how many chains a thread runs and how its values reach memory:
//   * count_bytes: one lane per window, one class load a step (the count
//     kernel before its redesign).
//   * count_chains2: the package's count (word loads, a 32-step register
//     tile), each thread running two segments of a window interleaved, so
//     two independent lookups are in flight a thread; segments 2 or 4.
//   * hotstate_rows: one lane per window, one class load a step, each lane
//     storing 4 bytes a step at its own row of the output (the hotstate
//     kernel before its redesign).
//   * hotstate_tile_bytes: the package's hotstate plane (tile::planes_lane,
//     the 16-step store tile, K lanes per window) with one class load a step
//     instead of word loads.

#include <cstdint>

#include <cuda_runtime.h>

#include "../csrc/tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_bytes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                       int64_t num_windows, int width, int halo, uint32_t num_classes,
                       int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = tile::warm_up(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; ++t) {
      const uint32_t v = tile::lookup(table, s, row[t], num_classes);
      pop += __popc(v >> state_bits);
      s = v & smask;
    }
  }
  tile::block_add<kThreads>(pop, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_chains2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                         int64_t num_windows, int width, int halo, uint32_t num_classes,
                         int state_bits, int segments, int seg_len,
                         unsigned long long* __restrict__ out) {
  // Thread h of window b runs segments h and h + segments / 2.
  const int half = segments / 2;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / half;
  const int64_t first = b * segments + (g - b * half);
  const tile::Segment sg[2] = {
      tile::segment_of(first, num_windows, width, halo, segments, seg_len),
      tile::segment_of(first + half, num_windows, width, halo, segments, seg_len)};
  const uint32_t smask = (1u << state_bits) - 1u;
  const T* seg[2];
  uint32_t s[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < 2; ++c) seg[c] = windows + sg[c].b * width + sg[c].start;
  if (sg[0].len > 0) {  // the second segment is then in the same row
    for (int t = 0; t < halo; ++t) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        s[c] = tile::lookup(table, s[c], seg[c][t], num_classes) & smask;
    }
  }
  uint32_t pop = 0;
  const int steps = max(sg[0].len, sg[1].len);
  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    int n[2];
    tile::ClassWords<T, kSteps> cls[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      n[c] = min(kSteps, sg[c].len - t0);
      cls[c].load(seg[c] + halo + t0, n[c]);
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (t < n[c]) {
          const uint32_t v = tile::lookup(table, s[c], cls[c].at(t), num_classes);
          pop += __popc(v >> state_bits);
          s[c] = v & smask;
        }
      }
    }
  }
  tile::block_add<kThreads>(pop, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hotstate_rows_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                         int64_t num_windows, int width, int halo, uint32_t num_classes,
                         int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = tile::warm_up(table, row, halo, num_classes, smask);
  uint32_t* dst = out + b * (width - halo);
  for (int t = halo; t < width; ++t) {
    const uint32_t v = tile::lookup(table, s, row[t], num_classes);
    dst[t - halo] = (v >> state_bits) != 0u ? v : 0u;
    s = v & smask;
  }
}

// One class load a step, at the step: tile::ClassWords' interface.
template <typename T>
struct ClassBytes {
  const T* first;
  __device__ __forceinline__ void load(const T* f, int) { first = f; }
  __device__ __forceinline__ uint32_t at(int t) const { return __ldg(first + t); }
};

struct HotEntry {  // huge_scan.cu's value per body position
  int state_bits;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return (v >> state_bits) != 0u ? v : 0u;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hotstate_tile_bytes_kernel(const uint32_t* __restrict__ table,
                               const T* __restrict__ windows, int64_t num_windows, int width,
                               int halo, uint32_t num_classes, int state_bits, int segments,
                               int seg_len, bool vec, uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  tile::planes_lane<ClassBytes<T>>(table, windows, num_windows, width, halo, num_classes,
                                   (1u << state_bits) - 1u, segments, seg_len, vec, tiles, out,
                                   HotEntry{state_bits});
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// The launch of variant `which` with window type T; false if it does not
// take these segments.
template <typename T>
bool launch(int which, const uint32_t* tab, const void* windows, int64_t num_windows,
            int width, int halo, uint32_t a, int state_bits, int segments, int seg_len,
            void* out, cudaStream_t st) {
  const auto* w = static_cast<const T*>(windows);
  const int body = width - halo;
  auto* count = static_cast<unsigned long long*>(out);
  auto* plane = static_cast<uint32_t*>(out);
  switch (which) {
    case 0:
      if (segments != 1) return false;
      count_bytes_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
          tab, w, num_windows, width, halo, a, state_bits, count);
      return true;
    case 1:
      if (segments != 2 && segments != 4) return false;
      count_chains2_kernel<T><<<grid_for(num_windows * segments / 2), kThreads, 0, st>>>(
          tab, w, num_windows, width, halo, a, state_bits, segments, seg_len, count);
      return true;
    case 2:
      if (segments != 1) return false;
      hotstate_rows_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
          tab, w, num_windows, width, halo, a, state_bits, plane);
      return true;
    default:
      hotstate_tile_bytes_kernel<T><<<grid_for(num_windows * segments), kThreads, 0, st>>>(
          tab, w, num_windows, width, halo, a, state_bits, segments, seg_len,
          tile::vec_runs(body, seg_len, plane), plane);
      return true;
  }
}

int entry(int which, const void* table, const void* windows, int window_bytes,
          int64_t num_windows, int width, int halo, int num_classes, int state_bits,
          int segments, int seg_len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!tile::valid_segments(segments, seg_len, width - halo, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto a = static_cast<uint32_t>(num_classes);
  auto st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (window_bytes == 1) {
    ok = launch<uint8_t>(which, tab, windows, num_windows, width, halo, a, state_bits,
                         segments, seg_len, out, st);
  } else if (window_bytes == 2) {
    ok = launch<uint16_t>(which, tab, windows, num_windows, width, halo, a, state_bits,
                          segments, seg_len, out, st);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of packed_scan_count / packedcount_hotstate_plane (the
// table 2-D or flat, row stride num_classes), segments included.
#define VARIANT(name, which)                                                              \
  extern "C" int name(const void* table, const void* windows, int window_bytes,          \
                      int64_t num_windows, int width, int halo, int num_classes,           \
                      int state_bits, int segments, int seg_len, void* out, int device,    \
                      void* stream) {                                                      \
    return entry(which, table, windows, window_bytes, num_windows, width, halo,            \
                 num_classes, state_bits, segments, seg_len, out, device, stream);         \
  }

VARIANT(count_bytes, 0)
VARIANT(count_chains2, 1)
VARIANT(hotstate_rows, 2)
VARIANT(hotstate_tile_bytes, 3)
