// Designs of the count kernel, the hotstate plane, the count-packed count and
// the split emit planes that the package does not use, kept so that
// python -m ahocorasick_tpu_torch.bench.scan_variants can time them beside
// csrc/packed_scan.cu's packed_scan_count and csrc/huge_scan.cu's
// packedcount_hotstate_plane, packedcount_count and split_emit_planes on the
// card.
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
//   * packedcount_bytes: one lane per window, one class load a step (the
//     count-packed count before its redesign).
//   * split_rows: one lane per window, one class load a step, the P emit
//     loads of a step in the chain, each lane storing 4 bytes a step and
//     plane at its own row of the output (the split planes before their
//     redesign).
//   * split_inline: the package's split planes (the planes lane, K lanes per
//     window) with one plane (P = 1) loaded as each entry is read, in the
//     chain, instead of gathered after the tile's lookups.
//   * split_pipelined: the same lane (P = 1) with the gather of a tile's
//     planes issued before the next tile's lookups and stored after them, so
//     that its latency hides behind the next tile's chain.

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
  static constexpr bool kGather = false;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packedcount_bytes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                             int64_t num_windows, int width, int halo, uint32_t num_classes,
                             int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = tile::warm_up(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; ++t) {
      const uint32_t v = tile::lookup(table, s, row[t], num_classes);
      total += v >> state_bits;
      s = v & smask;
    }
  }
  tile::block_add<kThreads>(total, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_rows_kernel(const uint32_t* __restrict__ dfa, const uint32_t* __restrict__ emit,
                      const T* __restrict__ windows, int64_t num_windows, int width, int halo,
                      uint32_t num_classes, int num_planes, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const int64_t body = width - halo;
  const int64_t plane_stride = num_windows * body;  // B*C
  uint32_t s = tile::warm_up(dfa, row, halo, num_classes, 0xffffffffu);
  uint32_t* dst = out + b * body;
  for (int t = halo; t < width; ++t) {
    s = tile::lookup(dfa, s, row[t], num_classes);
    const uint32_t* e = emit + static_cast<uint64_t>(s) * num_planes;
    for (int p = 0; p < num_planes; ++p) dst[p * plane_stride + (t - halo)] = __ldg(e + p);
  }
}

// Plane 0 of a state's emit_tab row, loaded in the chain (P = 1).
struct EmitInline {
  static constexpr bool kGather = false;
  const uint32_t* emit;
  __device__ __forceinline__ uint32_t operator()(uint32_t s) const { return __ldg(emit + s); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_inline_kernel(const uint32_t* __restrict__ dfa, const uint32_t* __restrict__ emit,
                        const T* __restrict__ windows, int64_t num_windows, int width, int halo,
                        uint32_t num_classes, int segments, int seg_len, bool vec,
                        uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  tile::planes_lane<tile::ClassWords<T>>(dfa, windows, num_windows, width, halo, num_classes,
                                         0xffffffffu, segments, seg_len, vec, tiles, out,
                                         EmitInline{emit});
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_pipelined_kernel(const uint32_t* __restrict__ dfa, const uint32_t* __restrict__ emit,
                           const T* __restrict__ windows, int64_t num_windows, int width,
                           int halo, uint32_t num_classes, int segments, int seg_len, bool vec,
                           uint32_t* __restrict__ out) {
  using tile::kTileSteps;
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const tile::Segment sg = tile::segment_of(g, num_windows, width, halo, segments, seg_len);
  const T* seg = windows + sg.b * width + sg.start;
  uint32_t s = sg.len > 0 ? tile::warm_up(dfa, seg, halo, num_classes, 0xffffffffu) : 0u;
  seg += halo;
  uint32_t* row = tiles + threadIdx.x * tile::kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * tile::kPitch;
  const long long dst = sg.b * (width - halo) + sg.start;
  const int steps = __reduce_max_sync(tile::kFull, sg.len);
  uint32_t e[kTileSteps];  // the previous tile's planes, loaded during this tile's chain
  for (int t0 = 0; t0 < steps + kTileSteps; t0 += kTileSteps) {
    uint32_t state[kTileSteps];
    if (t0 < steps) {
      const int n = min(kTileSteps, sg.len - t0);
      tile::ClassWords<T> cls;
      cls.load(seg + t0, n);
#pragma unroll
      for (int t = 0; t < kTileSteps; ++t) {
        if (t < n) s = tile::lookup(dfa, s, cls.at(t), num_classes);
        state[t] = t < n ? s : 0u;
      }
    }
    if (t0 > 0) {
#pragma unroll
      for (int t = 0; t < kTileSteps; ++t) row[t] = e[t];
      __syncwarp();
      tile::store_tile(warp_tile, lane, dst + t0 - kTileSteps,
                       min(kTileSteps, sg.len - (t0 - kTileSteps)), vec, out);
      __syncwarp();
    }
    if (t0 < steps) {
#pragma unroll
      for (int t = 0; t < kTileSteps; ++t) e[t] = __ldg(emit + state[t]);
    }
  }
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
    case 4:
      if (segments != 1) return false;
      packedcount_bytes_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
          tab, w, num_windows, width, halo, a, state_bits, count);
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
VARIANT(packedcount_bytes, 4)

namespace {

// The arguments of split_emit_planes, segments included: `which` 0 is
// split_rows (one lane per window), 1 split_inline and 2 split_pipelined (one
// plane).
int split_entry(int which, const void* dfa_flat, const void* emit_tab, const void* windows,
                int window_bytes, int64_t num_windows, int width, int halo, int num_classes,
                int num_planes, int segments, int seg_len, void* out, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int body = width - halo;
  if (!tile::valid_segments(segments, seg_len, body, halo) || (which == 0 && segments != 1) ||
      (which >= 1 && num_planes != 1) || (window_bytes != 1 && window_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* dfa = static_cast<const uint32_t*>(dfa_flat);
  const auto* emit = static_cast<const uint32_t*>(emit_tab);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* planes = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = tile::vec_runs(body, seg_len, planes);
  const unsigned grid = grid_for(num_windows * segments);
  const auto* w8 = static_cast<const uint8_t*>(windows);
  const auto* w16 = static_cast<const uint16_t*>(windows);
  if (which == 0 && window_bytes == 1) {
    split_rows_kernel<uint8_t><<<grid, kThreads, 0, st>>>(dfa, emit, w8, num_windows, width,
                                                          halo, a, num_planes, planes);
  } else if (which == 0) {
    split_rows_kernel<uint16_t><<<grid, kThreads, 0, st>>>(dfa, emit, w16, num_windows, width,
                                                           halo, a, num_planes, planes);
  } else if (which == 2 && window_bytes == 1) {
    split_pipelined_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, w8, num_windows, width, halo, a, segments, seg_len, vec, planes);
  } else if (which == 2) {
    split_pipelined_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, w16, num_windows, width, halo, a, segments, seg_len, vec, planes);
  } else if (window_bytes == 1) {
    split_inline_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, w8, num_windows, width, halo, a, segments, seg_len, vec, planes);
  } else {
    split_inline_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        dfa, emit, w16, num_windows, width, halo, a, segments, seg_len, vec, planes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SPLIT_VARIANT(name, which)                                                         \
  extern "C" int name(const void* dfa_flat, const void* emit_tab, const void* windows,     \
                      int window_bytes, int64_t num_windows, int width, int halo,          \
                      int num_classes, int num_planes, int segments, int seg_len,          \
                      void* out, int device, void* stream) {                               \
    return split_entry(which, dfa_flat, emit_tab, windows, window_bytes, num_windows,      \
                       width, halo, num_classes, num_planes, segments, seg_len, out,       \
                       device, stream);                                                    \
  }

SPLIT_VARIANT(split_rows, 0)
SPLIT_VARIANT(split_inline, 1)
SPLIT_VARIANT(split_pipelined, 2)
