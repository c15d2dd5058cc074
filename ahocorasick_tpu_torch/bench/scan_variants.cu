// Designs of the count kernel, the hotstate plane, the count-packed count,
// the split emit planes and count, the stride-2 count and planes, the
// row-sharded scan, the whole-word-longest die sweep, the PFAC v2 walk, the
// probes' row read and the stitch's fold that the package does not use, kept
// so that python -m ahocorasick_tpu_torch.bench.scan_variants can time them
// beside the package's kernels (csrc/packed_scan.cu, huge_scan.cu,
// rowdfa2_scan.cu, table_sharded.cu, wwl_scan.cu, pfac_scan.cu, probes.cu,
// stitch.cu) on the card.
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
//   * seq_serial_first, shortest_first: the sequential scans' one-thread
//     walks (csrc/seq_scan.cu seq_states_spec computes both): the serial walk
//     of the dense or RowTable form in one block whose threads stage a tile
//     of 2,048 int32 classes in shared memory and store it back while thread
//     0 walks it (the first seq_states), and the leftmost-shortest restart
//     scan in one thread, two dependent loads a class (match_len[s], then
//     dfa_next[row * A + c]) and its classes read from global memory in the
//     chain (the first shortest_states).
//   * maps_first, rescan_first: the chunk stitch's first designs for tables
//     that do not synchronize (csrc/stitch.cu state_maps_all and
//     csrc/seq_scan.cu rescan_serial compute them): every (chunk, entry
//     state) lane walking its whole chunk, the classes staged in shared
//     memory, and each chunk's rescan walked by thread 0 of a block while
//     the others stage tiles.
//   * pfac_first: the PFAC v2 walk (csrc/pfac_scan.cu pfac2_planes and
//     pfac2_count) in its first design, one thread a start over a grid of
//     256-thread blocks, its classes and the prefix table read from global
//     memory, the count one 64-bit atomic add a block; and that count with
//     each block's sum stored to its own slot instead of the atomic.
//   * pfac_tiles: the v2 walk over tiles of starts with block barriers
//     (persistent blocks, each tile's classes and planes staged in shared
//     memory), with refills from the tile's shared counter, or one or two
//     walks a thread without; each tile waits for its longest walk.
//   * pfac_queue: csrc/pfac_walk.cuh's walk at other block and prefix-pass
//     widths than the package's (uint8 classes).
//   * wwl_fused_first: the whole-word-longest fused scan (csrc/wwl_scan.cu
//     wwl_scan_fused) in its first design, a cursor over the sorted starts in
//     each lane's chain, records, and a resolve launch a thread a slot.
//   * wwl_walk_first: the per-start trie walk (csrc/wwl_walk.cu
//     wwl_walks_at) in its first design, one thread a start.
//   * row_chain_first: the probes' row read (csrc/probes.cu row_chain) in
//     its first design, a warp a chain.
//   * entry_fold_first: the stitch's fold (csrc/stitch.cu entry_fold) in its
//     first design, one thread walking the chain.
//   * chain_independent, chain_arm: measurement arms of the probes' lookup
//     chain (csrc/probes.cu chain_gather, global placement, the load op):
//     the same number of loads from the same table at addresses that do not
//     depend on the loaded values (the card's rate of random requests), and
//     the chain with __ldcg instead of __ldg, with the L1 carve-out at its
//     largest, with 2 or 4 chains a thread issued back to back, or on a grid
//     of exactly one block an SM with the chains split evenly.

#include <cstdint>

#include <cuda_runtime.h>

#include "../csrc/pfac_walk.cuh"
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

namespace {

constexpr int kSerialTile = 2048;

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
seq_serial_first_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ row_id,
                        const int32_t* __restrict__ cls, int64_t n, int64_t num_classes,
                        int32_t s0, int32_t* __restrict__ out) {
  __shared__ int32_t tile[kSerialTile];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = s0;
  for (int64_t base = 0; base < n; base += kSerialTile) {
    const int len = static_cast<int>(n - base < kSerialTile ? n - base : kSerialTile);
    for (int i = threadIdx.x; i < len; i += kThreads) tile[i] = cls[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t s = carry;
      for (int i = 0; i < len; ++i) {
        const int64_t row = kRows ? __ldg(row_id + s) : s;
        s = __ldg(table + (row * num_classes + tile[i]));
        tile[i] = s;
      }
      carry = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) out[base + i] = tile[i];
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
}

template <typename T>
__global__ void shortest_first_kernel(const int32_t* __restrict__ dfa_next,
                                      const int32_t* __restrict__ match_len,
                                      const T* __restrict__ cls, int64_t n, int64_t num_classes,
                                      int32_t* __restrict__ out) {
  int32_t s = 0;  // the root
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = __ldg(match_len + s) > 0 ? 0 : s;
    s = __ldg(dfa_next + (static_cast<int64_t>(row) * num_classes + cls[i]));
    out[i] = s;
  }
}

}  // namespace

// The serial walk's first design: out int32[n] from s0 over `table` (row_id
// null: dense int32[S, A]; otherwise the distinct rows and row_id int32[S])
// and int32 classes.
extern "C" int seq_serial_first(const void* table, const void* row_id, const void* cls,
                                int64_t n, int num_classes, int s0, void* out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || num_classes < 1 || s0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* rid = static_cast<const int32_t*>(row_id);
  const auto* c = static_cast<const int32_t*>(cls);
  auto* states = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (rid != nullptr) {
    seq_serial_first_kernel<true><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0,
                                                          states);
  } else {
    seq_serial_first_kernel<false><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0,
                                                           states);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shortest restart scan's first design: out int32[n] from the root over
// the padded dfa_next int32[S, A] and match_len int32[S], classes of
// cls_bytes bytes (1, 2 or 4).
extern "C" int shortest_first(const void* dfa_next, const void* match_len, const void* cls,
                              int cls_bytes, int64_t n, int num_classes, void* out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || num_classes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* next = static_cast<const int32_t*>(dfa_next);
  const auto* lens = static_cast<const int32_t*>(match_len);
  auto* states = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (cls_bytes == 1) {
    shortest_first_kernel<uint8_t><<<1, 1, 0, st>>>(next, lens, static_cast<const uint8_t*>(cls),
                                                    n, num_classes, states);
  } else if (cls_bytes == 2) {
    shortest_first_kernel<uint16_t><<<1, 1, 0, st>>>(
        next, lens, static_cast<const uint16_t*>(cls), n, num_classes, states);
  } else if (cls_bytes == 4) {
    shortest_first_kernel<int32_t><<<1, 1, 0, st>>>(next, lens, static_cast<const int32_t*>(cls),
                                                    n, num_classes, states);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kFirstMapThreads = 256;
constexpr int kFirstMapTile = 1024;
constexpr int kFirstScanThreads = 128;
constexpr int kFirstScanTile = 1024;

// The sigma maps' first design: one thread per (chunk, entry state) lane
// walks the whole chunk, the chunk's classes staged kFirstMapTile at a time.
__global__ void __launch_bounds__(kFirstMapThreads)
maps_first_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
                  int64_t chunk_len, int64_t num_states, int64_t num_classes,
                  int64_t blocks_per_chunk, int32_t* __restrict__ sigma) {
  __shared__ int32_t tile[kFirstMapTile];
  const int64_t chunk = blockIdx.x / blocks_per_chunk;
  const int64_t lane = (blockIdx.x % blocks_per_chunk) * kFirstMapThreads + threadIdx.x;
  const bool live = lane < num_states;
  const int32_t* row = cls + chunk * chunk_len;
  int32_t s = live ? static_cast<int32_t>(lane) : 0;
  for (int64_t base = 0; base < chunk_len; base += kFirstMapTile) {
    const int len =
        static_cast<int>(chunk_len - base < kFirstMapTile ? chunk_len - base : kFirstMapTile);
    for (int i = threadIdx.x; i < len; i += kFirstMapThreads) tile[i] = row[base + i];
    __syncthreads();
    if (live) {
      for (int i = 0; i < len; ++i)
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile[i]));
    }
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
  if (live) sigma[chunk * num_states + lane] = s;
}

// The rescan's first design: one block per chunk stages tiles and its
// thread 0 walks them.
__global__ void __launch_bounds__(kFirstScanThreads)
rescan_first_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
                    const int32_t* __restrict__ entry, int64_t chunk_len, int64_t num_classes,
                    int32_t* __restrict__ out) {
  __shared__ int32_t tile[kFirstScanTile];
  const int64_t chunk = blockIdx.x;
  const int32_t* row = cls + chunk * chunk_len;
  int32_t* orow = out + chunk * chunk_len;
  int32_t s = entry[chunk];  // thread 0 carries it across the tiles
  for (int64_t base = 0; base < chunk_len; base += kFirstScanTile) {
    const int len =
        static_cast<int>(chunk_len - base < kFirstScanTile ? chunk_len - base : kFirstScanTile);
    for (int i = threadIdx.x; i < len; i += kFirstScanThreads) tile[i] = row[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) {
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile[i]));
        tile[i] = s;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kFirstScanThreads) orow[base + i] = tile[i];
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
}

}  // namespace

// The sigma maps' first design (csrc/stitch.cu state_maps_all until it met a
// reference run): sigma int32[num_chunks, num_states] from the dense table
// int32[num_states, num_classes] and int32[num_chunks, chunk_len] classes.
extern "C" int maps_first(const void* table, const void* cls, int64_t num_chunks,
                          int64_t chunk_len, int64_t num_states, int num_classes, void* sigma,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 0 || num_states < 1 || num_classes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = (num_states + kFirstMapThreads - 1) / kFirstMapThreads;
  if (per > 2147483647 / num_chunks) return static_cast<int>(cudaErrorInvalidValue);
  maps_first_kernel<<<static_cast<unsigned>(per * num_chunks), kFirstMapThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(cls), chunk_len,
      num_states, num_classes, per, static_cast<int32_t*>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// The rescan's first design (csrc/stitch.cu rescan_serial until it became
// speculate and repair by rows): out int32[num_chunks, chunk_len], chunk c
// walked from entry[c] by one thread.
extern "C" int rescan_first(const void* table, const void* cls, const void* entry,
                            int64_t num_chunks, int64_t chunk_len, int num_classes, void* out,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || num_chunks > 2147483647 || chunk_len < 1 || num_classes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rescan_first_kernel<<<static_cast<unsigned>(num_chunks), kFirstScanThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(entry), chunk_len, num_classes, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kPfacFirstThreads = 256;
constexpr uint32_t kPfacStateMask = (1u << 28) - 1u;

enum PfacFirstMode { kFirstPlanes = 0, kFirstCount = 1, kFirstCountSlots = 2 };

// The v2 walk's first design: thread i walks start i to its end; the warp
// runs as long as its longest walk.
template <typename C, int kMode>
__global__ void __launch_bounds__(kPfacFirstThreads)
    pfac_first_kernel(const uint32_t* __restrict__ trie, int stride,
                      const uint32_t* __restrict__ prefix, uint32_t threshold, uint32_t dead,
                      const C* __restrict__ cls, int64_t n, int depth, int k,
                      uint32_t num_classes, int num_planes, uint32_t* __restrict__ planes,
                      unsigned long long* __restrict__ count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPfacFirstThreads + threadIdx.x;
  uint32_t pop = 0;
  if (i < n) {
    const C* c = cls + i;
    uint32_t word = 0;
    uint32_t gram = c[0];
    for (int j = 1; j < k; ++j) gram = gram * num_classes + c[j];
    const uint32_t packed = __ldg(prefix + gram);
    uint32_t st = packed & kPfacStateMask;
    const uint32_t hist = packed >> 28;
    for (int d = 1; d <= k; ++d) word |= ((hist >> (k - d)) & 1u) << (d - 1);
    int plane = 0;
    for (int kk = k; kk < depth && st != dead; ++kk) {
      if ((kk >> 5) != plane) {
        if (kMode == kFirstPlanes) {
          planes[static_cast<int64_t>(plane) * n + i] = word;
        } else {
          pop += __popc(word);
        }
        word = 0;
        plane = kk >> 5;
      }
      st = __ldg(trie + static_cast<uint64_t>(st) * stride + static_cast<uint32_t>(c[kk]));
      word |= static_cast<uint32_t>(st >= threshold) << (kk & 31);
    }
    if (kMode == kFirstPlanes) {
      planes[static_cast<int64_t>(plane) * n + i] = word;
      for (int p = plane + 1; p < num_planes; ++p) planes[static_cast<int64_t>(p) * n + i] = 0u;
    } else {
      pop += __popc(word);
    }
  }
  if (kMode != kFirstPlanes) {
    for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
    __shared__ uint32_t warp_sums[kPfacFirstThreads / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = pop;
    __syncthreads();
    if (warp == 0) {
      pop = lane < kPfacFirstThreads / 32 ? warp_sums[lane] : 0u;
      for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
      if (lane == 0) {
        if (kMode == kFirstCount) {
          if (pop != 0u) atomicAdd(count, static_cast<unsigned long long>(pop));
        } else {
          count[blockIdx.x] = pop;
        }
      }
    }
  }
}

template <typename C, int kMode>
void pfac_first_launch(unsigned grid, cudaStream_t st, const uint32_t* trie, int stride,
                       const uint32_t* prefix, uint32_t threshold, uint32_t dead, const void* cls,
                       int64_t n, int depth, int k, uint32_t a, int num_planes, void* out) {
  pfac_first_kernel<C, kMode><<<grid, kPfacFirstThreads, 0, st>>>(
      trie, stride, prefix, threshold, dead, static_cast<const C*>(cls), n, depth, k, a,
      num_planes, static_cast<uint32_t*>(out), static_cast<unsigned long long*>(out));
}

template <int kMode>
void pfac_first_mode(int cls_bytes, unsigned grid, cudaStream_t st, const uint32_t* trie,
                     int stride, const uint32_t* prefix, uint32_t threshold, uint32_t dead,
                     const void* cls, int64_t n, int depth, int k, uint32_t a, int num_planes,
                     void* out) {
  if (cls_bytes == 1) {
    pfac_first_launch<uint8_t, kMode>(grid, st, trie, stride, prefix, threshold, dead, cls, n,
                                      depth, k, a, num_planes, out);
  } else if (cls_bytes == 2) {
    pfac_first_launch<uint16_t, kMode>(grid, st, trie, stride, prefix, threshold, dead, cls, n,
                                       depth, k, a, num_planes, out);
  } else {
    pfac_first_launch<int32_t, kMode>(grid, st, trie, stride, prefix, threshold, dead, cls, n,
                                      depth, k, a, num_planes, out);
  }
}

}  // namespace

// The v2 walk's first design (csrc/pfac_scan.cu until its persistent
// walk).  mode 0: planes, out uint32[num_planes, n]; 1: the count, out
// uint64[1] zeroed; 2: the count without the atomic, out uint64[ceil(n /
// 256)], one block's sum a slot.  The other arguments as pfac2_planes'.
extern "C" int pfac_first(int mode, const void* trie, int stride, const void* prefix,
                          int64_t threshold, int64_t dead, const void* cls, int cls_bytes,
                          int64_t n, int depth, int k, int num_classes, int num_planes, void* out,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || stride < 1 || depth < 1 || num_planes < (depth + 31) / 32 || k < 1 ||
      k > depth || mode < 0 || mode > 2 ||
      (cls_bytes != 1 && cls_bytes != 2 && cls_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n + kPfacFirstThreads - 1) / kPfacFirstThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint32_t*>(trie);
  const auto* p = static_cast<const uint32_t*>(prefix);
  const auto thr = static_cast<uint32_t>(threshold);
  const auto dd = static_cast<uint32_t>(dead);
  const auto a = static_cast<uint32_t>(num_classes);
  if (mode == kFirstPlanes) {
    pfac_first_mode<kFirstPlanes>(cls_bytes, grid, st, t, stride, p, thr, dd, cls, n, depth, k,
                                  a, num_planes, out);
  } else if (mode == kFirstCount) {
    pfac_first_mode<kFirstCount>(cls_bytes, grid, st, t, stride, p, thr, dd, cls, n, depth, k, a,
                                 num_planes, out);
  } else {
    pfac_first_mode<kFirstCountSlots>(cls_bytes, grid, st, t, stride, p, thr, dd, cls, n, depth,
                                      k, a, num_planes, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The v2 walk over tiles of starts with block barriers (the design this
// repository tried before csrc/pfac_walk.cuh's warp spans): a block loops
// over tiles of `tile` starts, stages each tile's classes and keeps a planes
// tile in shared memory, and between two barriers walks the tile's starts
// (kRefill: idle lanes take the tile's next start from a shared counter, up
// to fill_rounds times before each step; kStatic / kStatic2: one or two
// walks a thread, thread-strided, no refills); each tile waits for its
// longest walk before the planes tile leaves with 16-byte stores.
namespace tiled {

constexpr int kStateBits = 28;  // ops/scan_pfac2._STATE_BITS
constexpr uint32_t kStateMask = (1u << kStateBits) - 1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory on the H100

enum Arm { kRefill = 0, kStatic = 1, kStatic2 = 2 };

// Everything a launch needs; the launch shape (tile, stage_len,
// staged_planes, grid) comes from kernels/scan_pfac.launch_shape.
struct Walk {
  const uint32_t* trie;  // uint32[S, stride], ranked
  const uint32_t* prefix;  // uint32[prefix_entries] = A^k packed entries
  const void* cls;  // n + depth padded classes of C
  uint32_t* planes;  // uint32[num_planes, n] (planes mode)
  unsigned long long* count;  // the total (count mode)
  int64_t n;
  int stride;
  uint32_t threshold, dead, num_classes;
  int depth, k, num_planes;
  int tile, stage_len, staged_planes, fill_rounds;
  int prefix_entries;
};

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared-memory bytes of a launch: the prefix table (if staged), the
// classes window, the planes tile.
inline int smem_bytes(const Walk& w, int cls_bytes, bool prefix_shared, bool count_mode) {
  return (prefix_shared ? round16(4 * w.prefix_entries) : 0) + round16(w.stage_len * cls_bytes) +
         (count_mode ? 0 : 4 * w.staged_planes * w.tile);
}

// count elements from src (global) to dst (shared, 16-byte aligned): 16-byte
// loads where src is aligned, element loads for the rest.
template <typename T, int kThreads>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
    const int vecs = static_cast<int>(count * sizeof(T)) >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < vecs; i += kThreads) d[i] = __ldg(s + i);
    done = static_cast<int>((vecs << 4) / sizeof(T));
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// One tile's view: the staged classes, the planes tile and their global rows.
template <typename C, bool kCount, bool kPrefixShared>
struct TileWalk {
  const Walk w;
  const uint32_t* prefix;  // shared memory or global
  const C* s_cls;  // classes [base, base + avail)
  const C* g_cls;  // cls + base
  uint32_t* s_out;  // staged_planes x tile words
  uint32_t* g_out;  // planes + base
  int avail;
  unsigned long long pop;

  __device__ __forceinline__ uint32_t prefix_at(uint32_t gram) const {
    return kPrefixShared ? prefix[gram] : __ldg(prefix + gram);
  }

  // The prefix jump of start `local`: st, the matches of depths 1..k as
  // bits 0..k-1 of word, and whether the walk goes on.
  __device__ __forceinline__ bool start(int local, uint32_t& st, uint32_t& word, int& kk) const {
    uint32_t gram = s_cls[local];
    for (int j = 1; j < w.k; ++j) gram = gram * w.num_classes + s_cls[local + j];
    const uint32_t packed = prefix_at(gram);
    st = packed & kStateMask;
    word = __brev(packed >> kStateBits) >> (32 - w.k);  // bit k - d of the history -> bit d - 1
    kk = w.k;
    return kk < w.depth && st != w.dead;
  }

  // Plane p's word of start `local`.
  __device__ __forceinline__ void put(int local, int p, uint32_t word) {
    if (kCount) {
      pop += __popc(word);
    } else if (p < w.staged_planes) {
      s_out[p * w.tile + local] = word;
    } else {
      g_out[static_cast<int64_t>(p) * w.n + local] = word;
    }
  }

  // The last word, in plane p, and the zeros of the planes after it that the
  // flush does not write.
  __device__ __forceinline__ void finish(int local, int p, uint32_t word) {
    put(local, p, word);
    if (!kCount) {
      for (int q = max(p + 1, w.staged_planes); q < w.num_planes; ++q)
        g_out[static_cast<int64_t>(q) * w.n + local] = 0u;
    }
  }

  // One trie load at depth kk; false when the walk ends there (and finish
  // has taken its last word).
  __device__ __forceinline__ bool step(int local, uint32_t& st, uint32_t& word, int& kk) {
    if ((kk & 31) == 0) {  // depths rise by one: plane by plane, in order
      put(local, (kk >> 5) - 1, word);
      word = 0u;
    }
    const int j = local + kk;
    const uint32_t c = static_cast<uint32_t>(j < avail ? s_cls[j] : g_cls[j]);
    st = __ldg(w.trie + (static_cast<uint64_t>(st) * static_cast<uint32_t>(w.stride) + c));
    word |= static_cast<uint32_t>(st >= w.threshold) << (kk & 31);
    ++kk;
    if (kk < w.depth && st != w.dead) return true;
    finish(local, (kk - 1) >> 5, word);
    return false;
  }
};

// kRefill: the warp hands out the tile's starts (s_next, shared by the
// block's warps) to its idle lanes.
template <typename TW>
__device__ __forceinline__ void walk_refill(TW& t, int cnt, int* s_next) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  bool live = false;
  bool more = true;  // warp-uniform: the tile may have starts left
  uint32_t st = 0u, word = 0u;
  int kk = 0, local = 0;
  while (true) {
    for (int r = 0; r < t.w.fill_rounds && more; ++r) {
      const unsigned idle = __ballot_sync(kFull, !live);
      if (idle == 0u) break;
      const int leader = __ffs(idle) - 1;
      int first = 0;
      if (static_cast<int>(lane) == leader) first = atomicAdd(s_next, __popc(idle));
      first = __shfl_sync(kFull, first, leader);
      more = first + __popc(idle) < cnt;
      if (!live) {
        local = first + __popc(idle & below);
        if (local < cnt) {
          live = t.start(local, st, word, kk);
          if (!live) t.finish(local, 0, word);  // ended at the prefix (k < 32)
        }
      }
    }
    if (!__any_sync(kFull, live)) {
      if (more) continue;
      break;
    }
    if (live) live = t.step(local, st, word, kk);
  }
}

// kStatic / kStatic2: thread-strided starts, kWalks interleaved a thread.
template <int kWalks, int kThreads, typename TW>
__device__ __forceinline__ void walk_static(TW& t, int cnt) {
  for (int l0 = threadIdx.x; l0 < cnt; l0 += kThreads * kWalks) {
    uint32_t st[kWalks], word[kWalks];
    int kk[kWalks];
    bool live[kWalks];
#pragma unroll
    for (int i = 0; i < kWalks; ++i) {
      const int local = l0 + i * kThreads;
      live[i] = false;
      if (local < cnt) {
        live[i] = t.start(local, st[i], word[i], kk[i]);
        if (!live[i]) t.finish(local, 0, word[i]);
      }
    }
    bool any = true;
    while (any) {
      any = false;
#pragma unroll
      for (int i = 0; i < kWalks; ++i) {
        if (live[i]) live[i] = t.step(l0 + i * kThreads, st[i], word[i], kk[i]);
        any |= live[i];
      }
    }
  }
}

template <typename C, bool kCount, bool kPrefixShared, int kThreads, int kArm>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads) walk_kernel(const Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_next;
  __shared__ unsigned long long s_sums[kThreads / 32];
  const int prefix_bytes = kPrefixShared ? round16(4 * w.prefix_entries) : 0;
  if (kPrefixShared) stage<uint32_t, kThreads>(reinterpret_cast<uint32_t*>(smem), w.prefix,
                                               w.prefix_entries);
  C* s_cls = reinterpret_cast<C*>(smem + prefix_bytes);
  uint32_t* s_out =
      reinterpret_cast<uint32_t*>(smem + prefix_bytes + round16(w.stage_len * sizeof(C)));
  if (!kCount) {
    for (int i = threadIdx.x; i < w.staged_planes * w.tile; i += kThreads) s_out[i] = 0u;
  }
  const C* cls = static_cast<const C*>(w.cls);
  const int64_t total = w.n + w.depth;
  const int64_t tiles = (w.n + w.tile - 1) / w.tile;
  TileWalk<C, kCount, kPrefixShared> t{
      w, kPrefixShared ? reinterpret_cast<const uint32_t*>(smem) : w.prefix, s_cls, cls, s_out,
      w.planes, 0, 0ull};
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * w.tile;
    const int cnt = static_cast<int>(min(static_cast<int64_t>(w.tile), w.n - base));
    t.avail = static_cast<int>(min(static_cast<int64_t>(w.stage_len), total - base));
    t.g_cls = cls + base;
    t.g_out = w.planes + base;
    stage<C, kThreads>(s_cls, t.g_cls, t.avail);
    if (threadIdx.x == 0) s_next = 0;
    __syncthreads();  // the classes (and the prefix, the zeroed tile) are in
    if (kArm == kRefill) {
      walk_refill(t, cnt, &s_next);
    } else {
      walk_static<kArm == kStatic2 ? 2 : 1, kThreads>(t, cnt);
    }
    __syncthreads();  // every walk of the tile has ended
    if (!kCount) {
      // Each thread stores and zeroes its own words: the next tile's walks
      // write the tile only after the next barrier.
      for (int p = 0; p < w.staged_planes; ++p) {
        uint32_t* row = s_out + p * w.tile;
        uint32_t* g = t.g_out + static_cast<int64_t>(p) * w.n;
        int done = 0;
        if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0u) {
          const int vecs = cnt >> 2;
          uint4* r4 = reinterpret_cast<uint4*>(row);
          uint4* g4 = reinterpret_cast<uint4*>(g);
          for (int i = threadIdx.x; i < vecs; i += kThreads) {
            g4[i] = r4[i];
            r4[i] = make_uint4(0u, 0u, 0u, 0u);
          }
          done = vecs << 2;
        }
        for (int i = done + threadIdx.x; i < cnt; i += kThreads) {
          g[i] = row[i];
          row[i] = 0u;
        }
      }
    }
  }
  if (kCount) {
    unsigned long long pop = t.pop;
    for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(kFull, pop, off);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) s_sums[warp] = pop;
    __syncthreads();
    if (warp == 0) {
      pop = lane < kThreads / 32 ? s_sums[lane] : 0ull;
      for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(kFull, pop, off);
      if (lane == 0 && pop != 0ull) atomicAdd(w.count, pop);
    }
  }
}

// Checks the launch shape, sets the kernel's shared-memory limit, launches.
template <typename C, bool kCount, bool kPrefixShared, int kThreads, int kArm>
int launch_typed(const Walk& w, unsigned grid, cudaStream_t stream) {
  const int smem = smem_bytes(w, sizeof(C), kPrefixShared, kCount);
  auto kernel = walk_kernel<C, kCount, kPrefixShared, kThreads, kArm>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// The shape checks every arm shares: tiles a multiple of 16 starts, the
// classes window at least the tile plus the k-gram and at most tile +
// depth, the staged planes within the planes, the shared memory within a
// block's.
inline bool valid(const Walk& w, int cls_bytes, bool prefix_shared, bool count_mode,
                  unsigned grid) {
  if (w.n < 1 || w.stride < 1 || w.depth < 1 || w.k < 1 || w.k > w.depth || w.k > 3 ||
      w.num_planes < (w.depth + 31) / 32 || w.prefix_entries < 1 || w.fill_rounds < 1 ||
      grid < 1u)
    return false;
  if (w.tile < 16 || w.tile % 16 != 0 || w.stage_len < w.tile + w.k ||
      w.stage_len > w.tile + w.depth || w.staged_planes < 0 || w.staged_planes > w.num_planes)
    return false;
  if (count_mode && w.staged_planes != 0) return false;
  return smem_bytes(w, cls_bytes, prefix_shared, count_mode) <= kMaxSmem;
}

template <bool kCount, int kThreads, int kArm>
int launch(const Walk& w, int cls_bytes, bool prefix_shared, unsigned grid,
           cudaStream_t stream) {
  if (!valid(w, cls_bytes, prefix_shared, kCount, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cls_bytes == 1) {
    return prefix_shared ? launch_typed<uint8_t, kCount, true, kThreads, kArm>(w, grid, stream)
                         : launch_typed<uint8_t, kCount, false, kThreads, kArm>(w, grid, stream);
  }
  if (cls_bytes == 2) {
    return prefix_shared ? launch_typed<uint16_t, kCount, true, kThreads, kArm>(w, grid, stream)
                         : launch_typed<uint16_t, kCount, false, kThreads, kArm>(w, grid, stream);
  }
  if (cls_bytes == 4) {
    return prefix_shared ? launch_typed<int32_t, kCount, true, kThreads, kArm>(w, grid, stream)
                         : launch_typed<int32_t, kCount, false, kThreads, kArm>(w, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tiled

// pfac_tiles' walk, uint8 classes: arm 0 the refills, 1 one walk a thread, 2
// two interleaved; count_mode 0 planes (out uint32[num_planes, n]) or 1 the
// count (out uint64[1] zeroed).  stage_len: the classes staged a tile (tile
// + k up to tile + depth); staged_planes: the planes in the planes tile.
extern "C" int pfac_tiles(int arm, int count_mode, const void* trie, int stride,
                          const void* prefix, int64_t threshold, int64_t dead, const void* cls,
                          int cls_bytes, int64_t n, int depth, int k, int num_classes,
                          int num_planes, int grid, int tile, int stage_len, int staged_planes,
                          int prefix_shared, int fill_rounds, void* out, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cls_bytes != 1 || arm < 0 || arm > 2) return static_cast<int>(cudaErrorInvalidValue);
  tiled::Walk w{};
  w.trie = static_cast<const uint32_t*>(trie);
  w.prefix = static_cast<const uint32_t*>(prefix);
  w.cls = cls;
  w.n = n;
  w.stride = stride;
  w.threshold = static_cast<uint32_t>(threshold);
  w.dead = static_cast<uint32_t>(dead);
  w.num_classes = static_cast<uint32_t>(num_classes);
  w.depth = depth;
  w.k = k;
  w.num_planes = num_planes;
  w.tile = tile;
  w.stage_len = stage_len;
  w.staged_planes = count_mode ? 0 : staged_planes;
  w.fill_rounds = fill_rounds;
  int64_t entries = 1;
  for (int j = 0; j < k; ++j) entries *= num_classes;
  w.prefix_entries = static_cast<int>(entries);
  w.planes = static_cast<uint32_t*>(out);
  w.count = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool shared = prefix_shared != 0;
  const auto g = static_cast<unsigned>(grid);
  using tiled::launch;
  if (count_mode) {
    return arm == 0   ? launch<true, 1024, tiled::kRefill>(w, 1, shared, g, st)
           : arm == 1 ? launch<true, 1024, tiled::kStatic>(w, 1, shared, g, st)
                      : launch<true, 1024, tiled::kStatic2>(w, 1, shared, g, st);
  }
  return arm == 0   ? launch<false, 1024, tiled::kRefill>(w, 1, shared, g, st)
         : arm == 1 ? launch<false, 1024, tiled::kStatic>(w, 1, shared, g, st)
                    : launch<false, 1024, tiled::kStatic2>(w, 1, shared, g, st);
}

namespace {

template <bool kCount, int kThreads, int kPerLane, int kBlocks>
int pfac_queue_launch(const pfac::Walk& w, bool shared, unsigned grid, cudaStream_t st) {
  if (!pfac::valid<kThreads, kPerLane>(w, grid)) return static_cast<int>(cudaErrorInvalidValue);
  return shared
             ? pfac::launch_typed<uint8_t, kCount, true, kThreads, kPerLane, kBlocks>(w, grid, st)
             : pfac::launch_typed<uint8_t, kCount, false, kThreads, kPerLane, kBlocks>(w, grid,
                                                                                     st);
}

// The widths of PFAC_WIDTHS in bench/scan_variants.py: (threads, starts a
// lane, blocks an SM).
template <bool kCount>
int pfac_queue_mode(int threads, int per_lane, int blocks, const pfac::Walk& w, bool shared,
                    unsigned grid, cudaStream_t st) {
  if (threads == 1024 && per_lane == 4 && blocks == 1)
    return pfac_queue_launch<kCount, 1024, 4, 1>(w, shared, grid, st);
  if (threads == 1024 && per_lane == 4 && blocks == 2)
    return pfac_queue_launch<kCount, 1024, 4, 2>(w, shared, grid, st);
  if (threads == 512 && per_lane == 4 && blocks == 2)
    return pfac_queue_launch<kCount, 512, 4, 2>(w, shared, grid, st);
  if (threads == 512 && per_lane == 8 && blocks == 2)
    return pfac_queue_launch<kCount, 512, 8, 2>(w, shared, grid, st);
  if (threads == 256 && per_lane == 4 && blocks == 4)
    return pfac_queue_launch<kCount, 256, 4, 4>(w, shared, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// csrc/pfac_walk.cuh's walk at other widths than the package's: threads a
// block, per_lane starts a lane in a prefix pass, blocks an SM (the
// register budget); uint8 classes; count_mode and out as pfac_tiles'; grid,
// span and prefix_shared as kernels/scan_pfac.launch_shape gives them for
// these widths.
extern "C" int pfac_queue(int threads, int per_lane, int blocks, int count_mode,
                          const void* trie, int stride, const void* prefix, int64_t threshold,
                          int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth,
                          int k, int num_classes, int num_planes, int grid, int64_t span,
                          int prefix_shared, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cls_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
  const pfac::Walk w = pfac::make_walk(trie, stride, prefix, threshold, dead, cls, n, depth, k,
                                       num_classes, num_planes, span, out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  const bool shared = prefix_shared != 0;
  return count_mode ? pfac_queue_mode<true>(threads, per_lane, blocks, w, shared, g, st)
                    : pfac_queue_mode<false>(threads, per_lane, blocks, w, shared, g, st);
}

// The whole-word-longest walks' first designs: the fused scan's lanes with a
// cursor over the sorted starts in the chain and a resolve launch
// (wwl_fused_first), and the per-start walk one thread a start
// (wwl_walk_first).
namespace wwl_first {

using sweep::write_outcome;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// First index in [lo, hi) whose start is >= value (> value with `after`),
// or hi.
__device__ __forceinline__ int64_t search(const int32_t* __restrict__ starts, int64_t lo,
                                          int64_t hi, int64_t value, bool after) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    const int64_t s = __ldg(starts + mid);
    if (s < value || (after && s == value)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first slot past a run of equal starts: called only at a duplicate, so
// kept out of line (the scan's unrolled loop holds sixteen call sites).
__device__ __noinline__ int32_t past_equal(const int32_t* __restrict__ starts, int32_t lo,
                                           int32_t hi, int32_t value) {
  return static_cast<int32_t>(search(starts, lo, hi, value, true));
}

// The fused scan's lanes: each writes the record of every distinct start of
// its segment that lies in [0, live).  Positions and slots are 32-bit (the
// wrapper keeps B*C below 2**31).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, int body, uint32_t stride, int d,
                 int id_bits, int depth_bits, int kd_bits, int cross, int segments,
                 int seg_len, const int32_t* __restrict__ starts, int64_t num_starts,
                 int64_t live, uint32_t* __restrict__ meta) {
  using tile::kTileSteps;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;  // window
  if (b >= num_windows) return;
  const int col0 = static_cast<int>(g - b * segments) * seg_len;  // the segment's first column
  const int32_t base = static_cast<int32_t>(b * body);  // text position of body column 0
  const int32_t lo = base + col0;
  const int32_t hi = static_cast<int32_t>(
      min64(min64(static_cast<int64_t>(lo) + seg_len, static_cast<int64_t>(base) + body), live));
  if (lo >= hi) return;
  const uint32_t idmask = (1u << id_bits) - 1u;
  const uint32_t dmask = (1u << depth_bits) - 1u;
  const T* row = windows + b * width;
  // Three chains of dependent loads at once: the warm-up from the root over
  // the halo classes before the segment, and the binary searches for the
  // segment's first start slot and for the first slot past the segment.
  uint32_t s = 0;
  int32_t a0 = 0, a1 = static_cast<int32_t>(num_starts);
  int32_t e0 = 0, e1 = a1;
  for (int t = 0; t < halo || a0 < a1 || e0 < e1; ++t) {
    if (t < halo) {
      const uint32_t c = static_cast<uint32_t>(row[col0 + t]);
      s = __ldg(table + (static_cast<uint64_t>(s) * stride + c)) & idmask;
    }
    if (a0 < a1) {
      const int32_t mid = a0 + (a1 - a0) / 2;
      if (__ldg(starts + mid) < lo) a0 = mid + 1; else a1 = mid;
    }
    if (e0 < e1) {
      const int32_t mid = e0 + (e1 - e0) / 2;
      if (__ldg(starts + mid) < hi) e0 = mid + 1; else e1 = mid;
    }
  }
  int32_t j = a0;
  const int32_t jend = e0;
  if (j >= jend) return;
  const int nflag = cross ? 2 : 1;
  int32_t sj = __ldg(starts + j);  // the next walk to die, then the one after it
  const int32_t s_last = __ldg(starts + jend - 1);
  if (sj < lo || s_last < sj) return;  // unsorted starts (the wrapper raises): read nothing
  int32_t sn = j + 1 < jend ? __ldg(starts + j + 1) : INT32_MAX;
  // The last body column a walk of this lane may need (within the row).
  const int steps = min(s_last - base + d, width - halo - 1) - col0 + 1;
  const T* body_cls = row + halo + col0;
  int32_t p = lo;  // text position of the tile's first char
  for (int t0 = 0; t0 < steps && j < jend; t0 += kTileSteps) {
    const int n = min(kTileSteps, steps - t0);
    tile::ClassWords<T> cls;
    cls.load(body_cls + t0, n);
    // The tile's lookups, a chain of dependent loads with nothing between
    // them, then its deaths found in a burst.
    uint32_t v[kTileSteps];
    uint32_t sp = s;  // the state before char t
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        v[t] = __ldg(table + (static_cast<uint64_t>(s) * stride + cls.at(t)));
        s = v[t] & idmask;
      }
    }
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        const int32_t gp = p + t - static_cast<int32_t>((v[t] >> id_bits) & dmask);
        while (sj <= gp) {  // the walk from sj died at p + t
          const uint32_t kd = static_cast<uint32_t>(p + t - sj);
          uint32_t rec = kd | (((v[t] >> (id_bits + depth_bits)) & 1u) << kd_bits);
          if (kd > 0) {
            if (cross) rec |= ((v[t] >> (id_bits + depth_bits + 1)) & 1u) << (kd_bits + 1);
            rec |= sp << (kd_bits + nflag);
          }
          meta[j] = rec;
          int32_t nj = j + 1;
          if (sn == sj) {  // equal starts: the resolve launch copies this record
            nj = past_equal(starts, nj, jend, sj);
            sn = nj < jend ? __ldg(starts + nj) : INT32_MAX;
          }
          j = nj;
          sj = sn;
          sn = j + 1 < jend ? __ldg(starts + j + 1) : INT32_MAX;
        }
        sp = v[t] & idmask;
      }
    }
    p += n;
  }
}

// A thread per start slot: the outcome from the record of its start.
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(const int32_t* __restrict__ starts, const uint32_t* __restrict__ meta,
                   const int32_t* __restrict__ outrows, int64_t num_starts, int64_t live,
                   int id_bits, int kd_bits, int cross, int32_t* __restrict__ die_pos,
                   bool* __restrict__ has, int32_t* __restrict__ m_start,
                   int32_t* __restrict__ m_end, int32_t* __restrict__ m_val,
                   bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  const int32_t w = starts[i];
  int32_t kd = 0, s_last = 0;
  bool die_word = false, crossed = false;
  if (w >= 0 && w < live) {
    const int64_t src = i > 0 && starts[i - 1] == w ? search(starts, 0, i, w, false) : i;
    const uint32_t rec = meta[src];
    const int nflag = cross ? 2 : 1;
    kd = static_cast<int32_t>(rec & ((1u << kd_bits) - 1u));
    die_word = (rec >> kd_bits) & 1u;
    crossed = cross && ((rec >> (kd_bits + 1)) & 1u);
    s_last = static_cast<int32_t>((rec >> (kd_bits + nflag)) & ((1u << id_bits) - 1u));
  }
  write_outcome(outrows, i, w, kd, die_word, crossed, s_last, die_pos, has, m_start, m_end,
                m_val, cont);
}


template <typename T>
__device__ __forceinline__ int64_t class_at(const T* __restrict__ cls, int64_t n, int64_t j) {
  return (j >= 0 && j < n) ? static_cast<int64_t>(__ldg(cls + j)) : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    walks_kernel(const int32_t* __restrict__ trie_next, const int32_t* __restrict__ own_len,
                 const int32_t* __restrict__ own_val, const int32_t* __restrict__ fail_len,
                 const int32_t* __restrict__ fail_off, const int32_t* __restrict__ fail_val,
                 const bool* __restrict__ class_is_word, int32_t dead, int64_t stride,
                 const T* __restrict__ cls, int64_t num_cls, const int32_t* __restrict__ starts,
                 int64_t num_starts, int max_depth, int32_t* __restrict__ die_pos,
                 bool* __restrict__ has, int32_t* __restrict__ m_start,
                 int32_t* __restrict__ m_end, int32_t* __restrict__ m_val) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  const int32_t w = starts[i];
  int32_t s = 0, s_last = 0, kd = -1;
  for (int k = 0; k <= max_depth; ++k) {
    const int32_t nxt = __ldg(trie_next + (s * stride + class_at(cls, num_cls, int64_t{w} + k)));
    if (nxt == dead) {
      kd = k;
      s_last = s;
      break;
    }
    s = nxt;
  }
  const int32_t dp = w + kd;
  const bool die_word = class_is_word[class_at(cls, num_cls, dp)];
  const int32_t own = __ldg(own_len + s_last), fail_l = __ldg(fail_len + s_last);
  const bool has_own = own > 0 && !die_word;
  const bool has_fail = fail_l > 0 && (die_word || own == 0);
  const int32_t end = has_own ? dp : dp - __ldg(fail_off + s_last);
  die_pos[i] = dp;
  has[i] = has_own || has_fail;
  m_start[i] = end - (has_own ? own : fail_l);
  m_end[i] = end;
  m_val[i] = has_own ? __ldg(own_val + s_last) : __ldg(fail_val + s_last);
}


}  // namespace wwl_first

// The fused scan's first design (csrc/wwl_scan.cu wwl_scan_fused computes the
// same): each lane binary-searches the sorted starts for its first slot and
// for the first slot past its segment (three chains with the warm-up),
// carries the next start in registers and writes one record a distinct start
// in the chain, a __noinline__ search past equal starts; a second launch, a
// thread a slot, resolves each slot from its start's record and its outrows
// row.  K <= 4 lanes a window (tile::valid_segments); meta is uint32[num_starts]
// scratch.
extern "C" int wwl_fused_first(const void* table, const void* windows, int class_bytes,
                               int64_t num_windows, int width, int halo, int stride, int d,
                               int id_bits, int depth_bits, int cross, int segments, int seg_len,
                               const void* starts, int64_t num_starts, const void* outrows,
                               void* meta, void* die_pos, void* has, void* m_start, void* m_end,
                               void* m_val, void* cont, int device, void* stream) {
  using namespace wwl_first;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kd_bits = 1;
  while ((1 << kd_bits) <= d) ++kd_bits;
  const int body = width - halo - (d + 1);
  if (num_windows < 1 || num_starts < 1 || d < 0 || halo < 0 || body < 1 || id_bits < 1 ||
      depth_bits < 1 || 1 + kd_bits + (cross ? 2 : 1) + id_bits > 32 ||
      !tile::valid_segments(segments, seg_len, body, halo) || (cross != 0) != (cont != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t live = num_windows * body - (d + 1);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* s = static_cast<const int32_t*>(starts);
  auto* rec = static_cast<uint32_t*>(meta);
  const unsigned grid = static_cast<unsigned>((num_windows * segments + kThreads - 1) / kThreads);
  const auto str = static_cast<uint32_t>(stride);
  if (class_bytes == 1) {
    fused_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else if (class_bytes == 2) {
    fused_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else if (class_bytes == 4) {
    fused_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const int32_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<static_cast<unsigned>((num_starts + kThreads - 1) / kThreads), kThreads, 0,
                   st>>>(
      s, rec, static_cast<const int32_t*>(outrows), num_starts, live, id_bits, kd_bits, cross,
      static_cast<int32_t*>(die_pos), static_cast<bool*>(has), static_cast<int32_t*>(m_start),
      static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val), static_cast<bool*>(cont));
  return static_cast<int>(cudaGetLastError());
}

// The per-start walk's first design (csrc/wwl_walk.cu wwl_walks_at computes
// the same): one thread a start in 256-thread blocks, the walk's trie loads
// and class loads with __ldg, the outcome from the five int32 arrays at the
// pre-die state and class_is_word at the die char.
extern "C" int wwl_walk_first(const void* trie_next, const void* own_len, const void* own_val,
                              const void* fail_len, const void* fail_off, const void* fail_val,
                              const void* class_is_word, int num_states, int stride,
                              const void* cls, int cls_bytes, int64_t num_cls, const void* starts,
                              int64_t num_starts, int max_depth, void* die_pos, void* has,
                              void* m_start, void* m_end, void* m_val, int device, void* stream) {
  using namespace wwl_first;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_starts < 1 || num_states < 1 || stride < 1 || max_depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((num_starts + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(trie_next);
  const auto* ol = static_cast<const int32_t*>(own_len);
  const auto* ov = static_cast<const int32_t*>(own_val);
  const auto* fl = static_cast<const int32_t*>(fail_len);
  const auto* fo = static_cast<const int32_t*>(fail_off);
  const auto* fv = static_cast<const int32_t*>(fail_val);
  const auto* cw = static_cast<const bool*>(class_is_word);
  const auto* s = static_cast<const int32_t*>(starts);
  auto* dp = static_cast<int32_t*>(die_pos);
  auto* h = static_cast<bool*>(has);
  auto* ms = static_cast<int32_t*>(m_start);
  auto* me = static_cast<int32_t*>(m_end);
  auto* mv = static_cast<int32_t*>(m_val);
  if (cls_bytes == 1) {
    walks_kernel<uint8_t><<<grid, kThreads, 0, st>>>(t, ol, ov, fl, fo, fv, cw, num_states - 1,
        stride, static_cast<const uint8_t*>(cls), num_cls, s, num_starts, max_depth, dp, h, ms,
        me, mv);
  } else if (cls_bytes == 2) {
    walks_kernel<uint16_t><<<grid, kThreads, 0, st>>>(t, ol, ov, fl, fo, fv, cw, num_states - 1,
        stride, static_cast<const uint16_t*>(cls), num_cls, s, num_starts, max_depth, dp, h, ms,
        me, mv);
  } else if (cls_bytes == 4) {
    walks_kernel<int32_t><<<grid, kThreads, 0, st>>>(t, ol, ov, fl, fo, fv, cw, num_states - 1,
        stride, static_cast<const int32_t*>(cls), num_cls, s, num_starts, max_depth, dp, h, ms,
        me, mv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// row_chain_first, entry_fold_first: the probes' row read (csrc/probes.cu
// row_chain) and the stitch's fold (csrc/stitch.cu entry_fold) in their
// first designs.

namespace probe_first {

constexpr int kRowThreads = 512;

template <bool kMax>
__global__ void __launch_bounds__(kRowThreads)
    row_first_kernel(const uint32_t* __restrict__ tab, int64_t rows, int width,
                     const uint32_t* __restrict__ s0, int64_t n, int reps, uint32_t mod,
                     uint32_t* __restrict__ out) {
  const int64_t chain = (static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (chain >= n) return;  // a whole warp leaves together
  const uint64_t last = static_cast<uint64_t>(rows) - 1u;
  uint32_t s = s0[chain];
  for (int r = 0; r < reps; ++r) {
    const uint32_t* row = tab + min(static_cast<uint64_t>(s), last) * width;
    uint32_t v = 0u;
    if (kMax) {
      for (int c = lane; c < width; c += 32) v = max(v, __ldg(row + c));
      v = __reduce_max_sync(0xffffffffu, v);
    } else {
      if (lane == 0) v = __ldg(row);
      v = __shfl_sync(0xffffffffu, v, 0);
    }
    s = v % mod;
  }
  if (lane == 0) out[chain] = s;
}

__global__ void fold_first_kernel(const int32_t* __restrict__ sigma, int64_t num_chunks,
                                  int64_t num_states, int32_t s0, int32_t* __restrict__ entry) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int32_t s = s0;
  for (int64_t c = 0; c < num_chunks; ++c) {
    entry[c] = s;
    if (c + 1 < num_chunks) s = __ldg(sigma + (c * num_states + s));
  }
}

}  // namespace probe_first

// The row read's first design: a warp a chain, lane c reading words c,
// c + 32, ... of the row as 4-byte words, the warp's max by
// __reduce_max_sync.  tab: uint32[rows][width]; s0, out: uint32[n]; reduce
// 0 = max, 1 = column 0.
extern "C" int row_chain_first(const void* tab, int64_t rows, int width, const void* s0,
                               int64_t n, int reps, int reduce, int64_t mod, void* out,
                               int device, void* stream) {
  using namespace probe_first;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || width < 1 || n < 1 || reps < 0 || mod < 1 || mod > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n * 32 + kRowThreads - 1) / kRowThreads);
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* s = static_cast<const uint32_t*>(s0);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<uint32_t>(mod);
  if (reduce == 0) {
    row_first_kernel<true><<<grid, kRowThreads, 0, st>>>(t, rows, width, s, n, reps, m, o);
  } else if (reduce == 1) {
    row_first_kernel<false><<<grid, kRowThreads, 0, st>>>(t, rows, width, s, n, reps, m, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fold's first design: one thread walks the C dependent loads.  entry
// int32[num_chunks] from sigma int32[num_chunks, num_states].
extern "C" int entry_fold_first(const void* sigma, int64_t num_chunks, int64_t num_states, int s0,
                                void* entry, int device, void* stream) {
  using namespace probe_first;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || num_states < 1 || s0 < 0 || s0 >= num_states)
    return static_cast<int>(cudaErrorInvalidValue);
  fold_first_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sigma), num_chunks, num_states, s0,
      static_cast<int32_t*>(entry));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// chain_independent, chain_arm: the lookup chain's measurement arms.

namespace probe_arms {

constexpr int kArmThreads = 512;

// A 32-bit mix of (chain, step): the independent arm's addresses.
__device__ __forceinline__ uint32_t mix(uint32_t c, uint32_t r) {
  uint32_t h = c * 0x9E3779B1u + r * 0x85EBCA77u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

__global__ void __launch_bounds__(kArmThreads)
    independent_kernel(const uint32_t* __restrict__ tab, uint32_t T, int64_t n, int reps,
                       uint32_t* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kArmThreads + threadIdx.x;
  if (c >= n) return;
  uint32_t sum = 0u;
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    sum += __ldg(tab + __umulhi(mix(static_cast<uint32_t>(c), static_cast<uint32_t>(r)), T));
  }
  out[c] = sum;
}

// The load op's chain, kChains a thread: slot t of m runs chains t, t + m,
// ...; `even`: gridDim.x blocks split the m slots evenly.
template <int kChains, bool kCg>
__global__ void __launch_bounds__(1024)
    chain_kernel(const uint32_t* __restrict__ tab, uint32_t T, const uint32_t* __restrict__ idx,
                 int64_t n, int reps, int64_t m, int even, uint32_t* __restrict__ out) {
  int64_t t;
  if (even) {
    const int64_t lo = m * blockIdx.x / gridDim.x, hi = m * (blockIdx.x + 1) / gridDim.x;
    t = lo + threadIdx.x;
    if (t >= hi) return;
  } else {
    t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= m) return;
  }
  const uint32_t last = T - 1u;
  uint32_t i[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) i[j] = t + j * m < n ? idx[t + j * m] : 0u;
  for (int r = 0; r < reps; ++r) {
    uint32_t v[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      v[j] = kCg ? __ldcg(tab + min(i[j], last)) : __ldg(tab + min(i[j], last));
    }
#pragma unroll
    for (int j = 0; j < kChains; ++j) i[j] = v[j];
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    if (t + j * m < n) out[t + j * m] = i[j];
  }
}

template <int kChains, bool kCg>
cudaError_t launch_arm(int carveout, int even, const uint32_t* tab, uint32_t T,
                       const uint32_t* idx, int64_t n, int reps, uint32_t* out, cudaStream_t st) {
  auto* kernel = chain_kernel<kChains, kCg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      carveout ? static_cast<int>(cudaSharedmemCarveoutMaxL1)
               : static_cast<int>(cudaSharedmemCarveoutDefault));
  if (err != cudaSuccess) return err;
  const int64_t m = (n + kChains - 1) / kChains;
  unsigned grid, block = kArmThreads;
  if (even) {
    int device, sms;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess) {
      return err;
    }
    grid = static_cast<unsigned>(sms);
    const int64_t per = (m + sms - 1) / sms;
    if (per > 1024) return cudaErrorInvalidValue;
    block = static_cast<unsigned>((per + 31) / 32 * 32);
  } else {
    grid = static_cast<unsigned>((m + kArmThreads - 1) / kArmThreads);
  }
  kernel<<<grid, block, 0, st>>>(tab, T, idx, n, reps, m, even, out);
  return cudaGetLastError();
}

}  // namespace probe_arms

// Arm (a) of the lookup chain: n x reps loads of tab (uint32[T]) at
// addresses mix(chain, step) scaled to [0, T), each chain's sum in out
// (uint32[n]), so that no load can be dropped.
extern "C" int chain_independent(const void* tab, int64_t T, int64_t n, int reps, void* out,
                                 int device, void* stream) {
  using namespace probe_arms;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || T > 0xffffffffLL || n < 1 || reps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((n + kArmThreads - 1) / kArmThreads);
  independent_kernel<<<grid, kArmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<uint32_t>(T), n, reps,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Arms (c)-(e) of the lookup chain, the load op (chain_gather's result):
// `chains` 1, 2 or 4 a thread; `cg` __ldcg instead of __ldg; `carveout` the
// L1 carve-out at its largest; `even` one block an SM, the chains split
// evenly.
extern "C" int chain_arm(int chains, int cg, int carveout, int even, const void* tab, int64_t T,
                         const void* idx, int64_t n, int reps, void* out, int device,
                         void* stream) {
  using namespace probe_arms;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || T > 0xffffffffLL || n < 1 || reps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* x = static_cast<const uint32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto tt = static_cast<uint32_t>(T);
  if (cg) {
    if (chains != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_arm<1, true>(carveout, even, t, tt, x, n, reps, o, st);
  } else if (chains == 1) {
    err = launch_arm<1, false>(carveout, even, t, tt, x, n, reps, o, st);
  } else if (chains == 2) {
    err = launch_arm<2, false>(carveout, even, t, tt, x, n, reps, o, st);
  } else if (chains == 4) {
    err = launch_arm<4, false>(carveout, even, t, tt, x, n, reps, o, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
