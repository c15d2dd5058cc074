// Designs of the count kernel, the hotstate plane, the count-packed count,
// the split emit planes and count, the stride-2 count and planes, the
// row-sharded scan and the whole-word-longest die sweep that the package does
// not use, kept so that
// python -m ahocorasick_tpu_torch.bench.scan_variants can time them beside
// the package's kernels (csrc/packed_scan.cu, huge_scan.cu, rowdfa2_scan.cu,
// table_sharded.cu, wwl_scan.cu) on the card.
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
//   * rowdfa2_count_bytes: the stride-2 count (csrc/rowdfa2_scan.cu) with
//     one lane per window and a class load a step (the stride-2 count before
//     its redesign).
//   * rowdfa2_planes_first: the stride-2 planes with one lane per window, a
//     class load a step and each pair stored as an 8-byte word at the lane's
//     own row (the stride-2 planes before their redesign).
//   * split_count_first: the split count with one lane per window, a class
//     load a step and the P emit loads of a step in the chain (the split
//     count before its redesign).
//   * split_count_gather32: the package's split count (the count lane, K
//     lanes per window) with the emit loads of all 32 steps of a tile
//     gathered at once instead of 16.
//   * table_sharded_first: the row-sharded scan (csrc/table_sharded.cu) in
//     its first design, one lane per window with a class load a step, the
//     owner's index by an integer division and its base pointer by a global
//     load in the chain, the planes modes storing 4 bytes a step at the
//     lane's own row.
//   * sweep_variant: the whole-word-longest die sweep (csrc/wwl_scan.cu
//     wwl_sweep_at and wwl_sweep_all) in its first design, a plane load only
//     after the test on the one before and the pre-die word read again
//     (group 0), and csrc/sweep.cuh's grouped sweep at G = 1, 2, 4, 8 and 16
//     loads a group, read from the plane or from a warp's span of the plane
//     staged in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "../csrc/sweep.cuh"
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
  tile::planes_lane<ClassBytes<T>>(tile::Dense{table, num_classes}, windows, num_windows, width,
                                   halo, (1u << state_bits) - 1u, segments, seg_len, vec, tiles,
                                   out, HotEntry{state_bits});
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
  tile::planes_lane<tile::ClassWords<T>>(tile::Dense{dfa, num_classes}, windows, num_windows,
                                         width, halo, 0xffffffffu, segments, seg_len, vec, tiles,
                                         out, EmitInline{emit});
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

namespace {

// The word of row (s, c0), column col of the stride-2 table.
__device__ __forceinline__ uint64_t row2(uint32_t s, uint32_t c0, uint32_t num_classes) {
  return (static_cast<uint64_t>(s) * num_classes + c0) * (num_classes + 1u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rowdfa2_count_bytes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                               int64_t num_windows, int width, int halo, uint32_t num_classes,
                               int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = 0;
    for (int t = 0; t < halo; t += 2) {
      s = __ldg(table + row2(s, row[t], num_classes) + row[t + 1]) & smask;
    }
    for (int t = halo; t < width; t += 2) {
      const uint32_t* r = table + row2(s, row[t], num_classes);
      const uint32_t w = __ldg(r + row[t + 1]);
      const uint32_t e1 = __ldg(r + num_classes);
      pop += __popc(w >> state_bits) + __popc(e1);
      s = w & smask;
    }
  }
  tile::block_add<kThreads>(pop, out);
}

}  // namespace

// The arguments of rowdfa2_count (segments must be 1: one lane per window).
extern "C" int rowdfa2_count_bytes(const void* table, const void* windows, int window_bytes,
                                   int64_t num_windows, int width, int halo, int num_classes,
                                   int state_bits, int segments, int seg_len, void* out,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (segments != 1 || seg_len != width - halo || halo % 2 != 0 || seg_len % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* count = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    rowdfa2_count_bytes_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, a, state_bits,
        count);
  } else if (window_bytes == 2) {
    rowdfa2_count_bytes_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, a, state_bits,
        count);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The stride-2 planes' first design (csrc/rowdfa2_scan.cu before it ran on
// the planes lane): one lane per window, a class load a step, each pair
// stored as one 8-byte word at the lane's own row (the 32 lanes of a warp
// 4*C bytes apart).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rowdfa2_planes_first_kernel(const uint32_t* __restrict__ table,
                                const T* __restrict__ windows, int64_t num_windows, int width,
                                int halo, uint32_t num_classes, int state_bits,
                                uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = 0;
  for (int t = 0; t < halo; t += 2) {
    s = __ldg(table + row2(s, row[t], num_classes) + row[t + 1]) & smask;
  }
  // C and the body offset are even, so each pair is an aligned 8-byte word.
  uint2* dst = reinterpret_cast<uint2*>(out + b * (width - halo));
  for (int t = halo; t < width; t += 2) {
    const uint32_t* r = table + row2(s, row[t], num_classes);
    const uint32_t w = __ldg(r + row[t + 1]);
    const uint32_t e1 = __ldg(r + num_classes);
    dst[(t - halo) >> 1] = make_uint2(e1, w >> state_bits);
    s = w & smask;
  }
}

// The split count's first design (csrc/huge_scan.cu before it ran on the
// count lane): one lane per window, a class load a step, and the P emit
// loads of a step in the chain.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_count_first_kernel(const uint32_t* __restrict__ dfa,
                             const uint32_t* __restrict__ emit, const T* __restrict__ windows,
                             int64_t num_windows, int width, int halo, uint32_t num_classes,
                             int num_planes, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    uint32_t s = tile::warm_up(dfa, row, halo, num_classes, 0xffffffffu);
    for (int t = halo; t < width; ++t) {
      s = tile::lookup(dfa, s, row[t], num_classes);
      const uint32_t* e = emit + static_cast<uint64_t>(s) * num_planes;
      for (int p = 0; p < num_planes; ++p) total += __popc(__ldg(e + p));
    }
  }
  tile::block_add<kThreads>(total, out);
}

// The package's split count (the count lane, emit loads gathered) with the
// states of all 32 steps of a tile gathered at once instead of 16.
struct EmitPopcounts32 {
  static constexpr bool kGather = true;
  static constexpr int kGatherSteps = tile::kCountSteps;
  const uint32_t* emit;
  int num_planes;
  __device__ __forceinline__ int planes() const { return num_planes; }
  __device__ __forceinline__ uint32_t operator()(uint32_t s, int p) const {
    return __popc(__ldg(emit + static_cast<uint64_t>(s) * num_planes + p));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_count_gather32_kernel(const uint32_t* __restrict__ dfa,
                                const uint32_t* __restrict__ emit,
                                const T* __restrict__ windows, int64_t num_windows, int width,
                                int halo, uint32_t num_classes, int num_planes, int segments,
                                int seg_len, unsigned long long* __restrict__ out) {
  const unsigned long long total = tile::count_lane<uint32_t>(
      tile::Dense{dfa, num_classes}, windows, num_windows, width, halo, 0xffffffffu, segments,
      seg_len, EmitPopcounts32{emit, num_planes});
  tile::block_add<kThreads>(total, out);
}

// `which` 0 is split_count_first (segments must be 1), 1 split_count_gather32.
template <typename T>
void launch_split_count(int which, const uint32_t* dfa, const uint32_t* emit,
                        const void* windows, int64_t num_windows, int width, int halo,
                        uint32_t a, int num_planes, int segments, int seg_len,
                        unsigned long long* out, cudaStream_t st) {
  const auto* w = static_cast<const T*>(windows);
  if (which == 0) {
    split_count_first_kernel<T><<<grid_for(num_windows), kThreads, 0, st>>>(
        dfa, emit, w, num_windows, width, halo, a, num_planes, out);
  } else {
    split_count_gather32_kernel<T><<<grid_for(num_windows * segments), kThreads, 0, st>>>(
        dfa, emit, w, num_windows, width, halo, a, num_planes, segments, seg_len, out);
  }
}

int split_count_entry(int which, const void* dfa_flat, const void* emit_tab,
                      const void* windows, int window_bytes, int64_t num_windows, int width,
                      int halo, int num_classes, int num_planes, int segments, int seg_len,
                      void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_planes < 1 || !tile::valid_segments(segments, seg_len, width - halo, halo) ||
      (which == 0 && segments != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* dfa = static_cast<const uint32_t*>(dfa_flat);
  const auto* emit = static_cast<const uint32_t*>(emit_tab);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* count = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    launch_split_count<uint8_t>(which, dfa, emit, windows, num_windows, width, halo, a,
                                num_planes, segments, seg_len, count, st);
  } else if (window_bytes == 2) {
    launch_split_count<uint16_t>(which, dfa, emit, windows, num_windows, width, halo, a,
                                 num_planes, segments, seg_len, count, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of rowdfa2_planes (segments must be 1: one lane per window).
extern "C" int rowdfa2_planes_first(const void* table, const void* windows, int window_bytes,
                                    int64_t num_windows, int width, int halo, int num_classes,
                                    int state_bits, int segments, int seg_len, void* out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (segments != 1 || seg_len != width - halo || halo % 2 != 0 || seg_len % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto a = static_cast<uint32_t>(num_classes);
  auto* planes = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    rowdfa2_planes_first_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, a, state_bits,
        planes);
  } else if (window_bytes == 2) {
    rowdfa2_planes_first_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, a, state_bits,
        planes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The arguments of split_count, segments included.
#define SPLIT_COUNT_VARIANT(name, which)                                                  \
  extern "C" int name(const void* dfa_flat, const void* emit_tab, const void* windows,     \
                      int window_bytes, int64_t num_windows, int width, int halo,          \
                      int num_classes, int num_planes, int segments, int seg_len,          \
                      void* out, int device, void* stream) {                               \
    return split_count_entry(which, dfa_flat, emit_tab, windows, window_bytes, num_windows, \
                             width, halo, num_classes, num_planes, segments, seg_len, out,   \
                             device, stream);                                                \
  }

SPLIT_COUNT_VARIANT(split_count_first, 0)
SPLIT_COUNT_VARIANT(split_count_gather32, 1)

// ---------------------------------------------------------------------------
// The row-sharded scan's first design (csrc/table_sharded.cu before it ran on
// the lane loops): one thread a window, a class load a step, the owner found
// by an integer division and its base pointer by a global load in the chain,
// and the planes modes storing 4 bytes a step at the lane's own row.

namespace {

struct FirstShards {
  const uint32_t* const* base;  // a device array of n_model pointers
  uint32_t n_model;
  uint32_t rows_per;
  uint32_t stride;
};

template <typename T>
__device__ __forceinline__ uint32_t first_lookup(const FirstShards& t, uint32_t s, T c) {
  const uint32_t k = s / t.rows_per;
  if (k >= t.n_model) return 0u;
  const uint32_t rel = s - k * t.rows_per;
  const auto* shard = reinterpret_cast<const uint32_t*>(
      __ldg(reinterpret_cast<const unsigned long long*>(t.base) + k));
  return __ldg(shard + (static_cast<uint64_t>(rel) * t.stride + static_cast<uint32_t>(c)));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    tp_first_count_kernel(FirstShards t, const T* __restrict__ windows, int64_t num_windows,
                          int width, int halo, int state_bits,
                          unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = 0;
    for (int i = 0; i < halo; ++i) s = first_lookup(t, s, row[i]) & smask;
    for (int i = halo; i < width; ++i) {
      const uint32_t v = first_lookup(t, s, row[i]);
      const uint32_t hi = v >> state_bits;
      total += MODE == 0 ? static_cast<uint32_t>(__popc(hi)) : hi;
      s = v & smask;
    }
  }
  tile::block_add<kThreads>(total, out);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    tp_first_plane_kernel(FirstShards t, const T* __restrict__ windows, int64_t num_windows,
                          int width, int halo, int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = 0;
  for (int i = 0; i < halo; ++i) s = first_lookup(t, s, row[i]) & smask;
  uint32_t* dst = out + b * (width - halo);
  for (int i = halo; i < width; ++i) {
    const uint32_t v = first_lookup(t, s, row[i]);
    const uint32_t hi = v >> state_bits;
    dst[i - halo] = MODE == 2 ? hi : MODE == 3 ? (hi != 0u ? v : 0u) : v;
    s = v & smask;
  }
}

template <typename T>
void tp_first_launch(const FirstShards& t, const void* windows, int64_t num_windows, int width,
                     int halo, int state_bits, int mode, void* out, cudaStream_t st) {
  const auto* w = static_cast<const T*>(windows);
  const unsigned grid = grid_for(num_windows);
  auto* total = static_cast<unsigned long long*>(out);
  auto* plane = static_cast<uint32_t*>(out);
  switch (mode) {
    case 0:
      tp_first_count_kernel<T, 0><<<grid, kThreads, 0, st>>>(t, w, num_windows, width, halo,
                                                             state_bits, total);
      break;
    case 1:
      tp_first_count_kernel<T, 1><<<grid, kThreads, 0, st>>>(t, w, num_windows, width, halo,
                                                             state_bits, total);
      break;
    case 2:
      tp_first_plane_kernel<T, 2><<<grid, kThreads, 0, st>>>(t, w, num_windows, width, halo,
                                                             state_bits, plane);
      break;
    case 3:
      tp_first_plane_kernel<T, 3><<<grid, kThreads, 0, st>>>(t, w, num_windows, width, halo,
                                                             state_bits, plane);
      break;
    default:
      tp_first_plane_kernel<T, 4><<<grid, kThreads, 0, st>>>(t, w, num_windows, width, halo,
                                                             state_bits, plane);
      break;
  }
}

}  // namespace

// The arguments of table_sharded_scan, segments included (they must be 1:
// one lane per window; the division constants are not used).  The shards
// must lie on `device`.
extern "C" int table_sharded_first(const void* shards, const int* owners, int n_model,
                                   int64_t rows_per, int stride, int64_t magic, int64_t add,
                                   int shift, const void* windows, int window_bytes,
                                   int64_t num_windows, int width, int halo, int state_bits,
                                   int mode, int segments, int seg_len, void* out, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_model < 1 || rows_per < 1 || rows_per > 0xffffffffLL || stride < 1 || mode < 0 ||
      mode > 4 || segments != 1 || seg_len != width - halo)
    return static_cast<int>(cudaErrorInvalidValue);
  const FirstShards t{static_cast<const uint32_t* const*>(shards),
                      static_cast<uint32_t>(n_model), static_cast<uint32_t>(rows_per),
                      static_cast<uint32_t>(stride)};
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    tp_first_launch<uint8_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  } else if (window_bytes == 2) {
    tp_first_launch<uint16_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  } else if (window_bytes == 4) {
    tp_first_launch<int32_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The whole-word-longest die sweep: its first design (a plane load only after
// the test on the one before, the pre-die word read again), and the grouped
// sweep of csrc/sweep.cuh at other groups G and with the staging on or off.

namespace {

__device__ __forceinline__ void first_sweep_one(
    const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
    const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows, int64_t i,
    int32_t w, int64_t live, int d, int id_bits, int depth_bits, int cross,
    int32_t* __restrict__ die_pos, bool* __restrict__ has, int32_t* __restrict__ m_start,
    int32_t* __restrict__ m_end, int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  const uint32_t idmask = (1u << id_bits) - 1u;
  const uint32_t dmask = (1u << depth_bits) - 1u;
  int32_t kd = 0;
  bool die_word = false, crossed = false;
  int32_t s_last = 0;
  if (w >= 0 && w < live) {
    kd = -1;
    for (int k = 0; k <= d; ++k) {
      const uint32_t v = __ldg(plane + (static_cast<int64_t>(w) + k));
      if (((v >> id_bits) & dmask) <= static_cast<uint32_t>(k)) {
        kd = k;
        die_word = (v >> (id_bits + depth_bits)) & 1u;
        crossed = cross && k > 0 && ((v >> (id_bits + depth_bits + 1)) & 1u);
        break;
      }
    }
    if (kd > 0) {
      const int64_t p = static_cast<int64_t>(w) + kd - 1;
      s_last = entry != nullptr ? __ldg(rows_flat + __ldg(entry + p))
                                : static_cast<int32_t>(__ldg(plane + p) & idmask);
    }
  }
  sweep::write_outcome(outrows, i, w, kd, die_word, crossed, s_last, die_pos, has, m_start,
                       m_end, m_val, cont);
}

// starts null: the sweep at every position 0 .. num_starts-1.
__global__ void __launch_bounds__(kThreads)
    first_sweep_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                       const int32_t* __restrict__ rows_flat,
                       const int32_t* __restrict__ outrows, const int32_t* __restrict__ starts,
                       int64_t num_starts, int64_t live, int d, int id_bits, int depth_bits,
                       int cross, int32_t* __restrict__ die_pos, bool* __restrict__ has,
                       int32_t* __restrict__ m_start, int32_t* __restrict__ m_end,
                       int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  first_sweep_one(plane, entry, rows_flat, outrows, i,
                  starts != nullptr ? starts[i] : static_cast<int32_t>(i), live, d, id_bits,
                  depth_bits, cross, die_pos, has, m_start, m_end, m_val, cont);
}

constexpr int kStageWords = 256;  // a warp's staged span of the plane

// The grouped sweep with a warp's span of the plane staged in shared memory:
// the warp copies [min w, max w + d] over its lanes' walking starts with
// coalesced loads (the sorted starts of compact_lanes lie within a few
// hundred positions; at every position the span is 32 + d), and its walks
// read their groups from there; a warp whose span is longer than
// kStageWords reads from the plane.  `starts` null: slot i starts at i.
template <int G>
__global__ void __launch_bounds__(kThreads)
    staged_sweep_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                        const int32_t* __restrict__ rows_flat,
                        const int32_t* __restrict__ outrows, const int32_t* __restrict__ starts,
                        int64_t n, int64_t live, int d, int id_bits, int depth_bits, int cross,
                        int32_t* __restrict__ die_pos, bool* __restrict__ has,
                        int32_t* __restrict__ m_start, int32_t* __restrict__ m_end,
                        int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  __shared__ uint32_t stage[kThreads / 32][kStageWords];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = i < n;
  const int32_t w = !in ? -1 : starts != nullptr ? __ldg(starts + i) : static_cast<int32_t>(i);
  const bool walk = in && w >= 0 && w < live;
  const int lane = threadIdx.x & 31;
  uint32_t* mine = stage[threadIdx.x >> 5];
  const uint32_t lo =
      __reduce_min_sync(0xffffffffu, walk ? static_cast<uint32_t>(w) : 0xffffffffu);
  const uint32_t hi = __reduce_max_sync(0xffffffffu, walk ? static_cast<uint32_t>(w) : 0u);
  const bool staged = lo <= hi && hi - lo + static_cast<uint32_t>(d) < kStageWords;
  if (staged) {
    const int span = static_cast<int>(hi - lo) + d + 1;
    for (int k = lane; k < span; k += 32) mine[k] = __ldg(plane + lo + k);
    __syncwarp();
  }
  sweep::Die r{0, false, false, 0u};
  if (walk) {
    r = staged ? sweep::die_of<G>(mine + (w - lo), false, d, id_bits, depth_bits, cross)
               : sweep::die_of<G>(plane + w, true, d, id_bits, depth_bits, cross);
  }
  if (in) {
    sweep::finish_slot(entry, rows_flat, outrows, i, w, r, id_bits, die_pos, has, m_start, m_end,
                       m_val, cont);
  }
}

template <int G, bool kStaged>
void grouped_sweep(const uint32_t* plane, const int32_t* entry, const int32_t* rows_flat,
                   const int32_t* outrows, const int32_t* starts, int64_t n, int64_t live, int d,
                   int id_bits, int depth_bits, int cross, int32_t* die_pos, bool* has,
                   int32_t* m_start, int32_t* m_end, int32_t* m_val, bool* cont,
                   cudaStream_t st) {
  if (kStaged) {
    staged_sweep_kernel<G><<<grid_for(n), kThreads, 0, st>>>(
        plane, entry, rows_flat, outrows, starts, n, live, d, id_bits, depth_bits, cross, die_pos,
        has, m_start, m_end, m_val, cont);
  } else if (starts != nullptr) {
    sweep::sweep_kernel<G><<<grid_for(n), kThreads, 0, st>>>(
        plane, entry, rows_flat, outrows, starts, n, live, d, id_bits, depth_bits, cross, die_pos,
        has, m_start, m_end, m_val, cont);
  } else {
    sweep::sweep_all_kernel<G><<<grid_for(n), kThreads, 0, st>>>(
        plane, entry, rows_flat, outrows, n, live, d, id_bits, depth_bits, cross, die_pos, has,
        m_start, m_end, m_val, cont);
  }
}

template <bool kStaged>
bool grouped_sweep_g(int group, const uint32_t* plane, const int32_t* entry,
                     const int32_t* rows_flat, const int32_t* outrows, const int32_t* starts,
                     int64_t n, int64_t live, int d, int id_bits, int depth_bits, int cross,
                     int32_t* die_pos, bool* has, int32_t* m_start, int32_t* m_end,
                     int32_t* m_val, bool* cont, cudaStream_t st) {
#define GROUP(g)                                                                            \
  case g:                                                                                   \
    grouped_sweep<g, kStaged>(plane, entry, rows_flat, outrows, starts, n, live, d, id_bits, \
                              depth_bits, cross, die_pos, has, m_start, m_end, m_val, cont,  \
                              st);                                                           \
    return true;
  switch (group) {
    GROUP(1)
    GROUP(2)
    GROUP(4)
    GROUP(8)
    GROUP(16)
    default:
      return false;
  }
#undef GROUP
}

}  // namespace

// The arguments of wwl_sweep_at with `starts` (null: wwl_sweep_all's sweep at
// every position 0 .. num_starts-1), and the design: group 0 is the first
// design; G = 1, 2, 4, 8 or 16 the grouped sweep, staged or not.
extern "C" int sweep_variant(int group, int staged, const void* plane, const void* entry,
                             const void* rows_flat, const void* outrows, const void* starts,
                             int64_t num_starts, int64_t live, int d, int id_bits, int depth_bits,
                             int cross, void* die_pos, void* has, void* m_start, void* m_end,
                             void* m_val, void* cont, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_starts < 1 || d < 0 || (entry == nullptr) != (rows_flat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint32_t*>(plane);
  const auto* e = static_cast<const int32_t*>(entry);
  const auto* rf = static_cast<const int32_t*>(rows_flat);
  const auto* o = static_cast<const int32_t*>(outrows);
  const auto* s = static_cast<const int32_t*>(starts);
  auto* dp = static_cast<int32_t*>(die_pos);
  auto* h = static_cast<bool*>(has);
  auto* ms = static_cast<int32_t*>(m_start);
  auto* me = static_cast<int32_t*>(m_end);
  auto* mv = static_cast<int32_t*>(m_val);
  auto* c = static_cast<bool*>(cont);
  auto st = static_cast<cudaStream_t>(stream);
  bool ok = true;
  if (group == 0) {
    first_sweep_kernel<<<grid_for(num_starts), kThreads, 0, st>>>(
        p, e, rf, o, s, num_starts, live, d, id_bits, depth_bits, cross, dp, h, ms, me, mv, c);
  } else if (staged) {
    ok = grouped_sweep_g<true>(group, p, e, rf, o, s, num_starts, live, d, id_bits, depth_bits,
                               cross, dp, h, ms, me, mv, c, st);
  } else {
    ok = grouped_sweep_g<false>(group, p, e, rf, o, s, num_starts, live, d, id_bits, depth_bits,
                                cross, dp, h, ms, me, mv, c, st);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
