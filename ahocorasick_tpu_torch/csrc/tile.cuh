// The lane-scan building blocks shared by the scans of packed_scan.cu,
// huge_scan.cu and wwl_scan.cu (their source notes say why each is there):
// the table lookup and the warm-up from the root, a block's sum of its
// lanes' counts, the segment of a window a lane scans, a lane's classes read
// a 32-bit word at a time, a warp's 16-step store tile in shared memory that
// leaves as whole sectors, and the lane loop of the planes kernels built
// from them.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tile {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileSteps = 16;           // body steps per store tile
constexpr int kPitch = kTileSteps + 1;   // words per lane row: 17, an odd bank stride
constexpr int kChunks = kTileSteps / 4;  // 16-byte chunks per run

template <typename T>
__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ table, uint32_t s, T c,
                                           uint32_t num_classes) {
  return __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
}

// The state after `halo` classes read from the root (state 0, a compiler
// invariant); smask is all ones where the table holds bare states.
template <typename T>
__device__ __forceinline__ uint32_t warm_up(const uint32_t* __restrict__ table,
                                            const T* __restrict__ row, int halo,
                                            uint32_t num_classes, uint32_t smask) {
  uint32_t s = 0;
  for (int t = 0; t < halo; ++t) s = lookup(table, s, row[t], num_classes) & smask;
  return s;
}

// Adds every thread's value to *out with one 64-bit atomic per block of
// kBlock threads (in-warp shuffles, then the warps' sums).  Every thread of
// the block must call it.
template <int kBlock>
__device__ __forceinline__ void block_add(unsigned long long v, unsigned long long* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  __shared__ unsigned long long warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0 && v != 0ull) atomicAdd(out, v);
  }
}

// K lanes per window of `body` positions, `seg_len` each (the last one
// shorter): 1 and body, or, when halo >= 1, K in 2..4 and seg_len a multiple
// of 4 with (K - 1) * seg_len < body <= K * seg_len.
inline bool valid_segments(int segments, int seg_len, int body, int halo) {
  const bool one = segments == 1 && seg_len == body;
  const bool split = segments >= 2 && segments <= 4 && halo >= 1 && seg_len % 4 == 0 &&
                     (segments - 1) * seg_len < body && segments * seg_len >= body;
  return one || split;
}

// Lane g of a grid of num_windows * segments lanes scans window b = g /
// segments from body position `start`, `len` positions (0 past the last
// window).  Its warm-up classes are row[start, start + halo), its body
// classes follow them.
struct Segment {
  int64_t b;
  int start;
  int len;
};

__device__ __forceinline__ Segment segment_of(int64_t g, int64_t num_windows, int width,
                                              int halo, int segments, int seg_len) {
  const int64_t b = g / segments;
  const int start = static_cast<int>(g - b * segments) * seg_len;
  const int len = b < num_windows ? min(seg_len, width - halo - start) : 0;
  return {b, start, len};
}

// The classes of a tile of up to kSteps steps, held as the aligned 32-bit
// words that contain them (kPer classes a word) and funnel-shifted into place
// by at().  load() reads no word past the one that holds the tile's last
// class, and none at all for n <= 0: a lane whose row is done loads nothing.
template <typename T, int kSteps = kTileSteps>
struct ClassWords {
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  static constexpr int kWords = kSteps / kPer;
  static constexpr uint32_t kMask =
      static_cast<uint32_t>((1ull << (8 * sizeof(T))) - 1ull);
  uint32_t raw[kWords + 1];
  uint32_t shift;

  __device__ __forceinline__ void load(const T* first, int n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(first);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    shift = static_cast<uint32_t>(a & 3u) * 8u;
    const int num_words =
        n > 0 ? (static_cast<int>(a & 3u) + n * static_cast<int>(sizeof(T)) + 3) / 4 : 0;
#pragma unroll
    for (int k = 0; k <= kWords; ++k) raw[k] = k < num_words ? __ldg(words + k) : 0u;
  }

  // Class t of the tile (t a compile-time constant after unrolling).
  __device__ __forceinline__ uint32_t at(int t) const {
    const uint32_t word = __funnelshift_r(raw[t / kPer], raw[t / kPer + 1], shift);
    return (word >> (8 * sizeof(T) * (t % kPer))) & kMask;
  }
};

// The warp's tile holds lane r's `count` words in tile[r*kPitch ...]; they go
// to out[start_r ...].  Lanes pass their start and count by shuffle.  With
// `vec`, 16-byte stores (kChunks lanes per run, so every sector is full; the
// runs must be 16-byte aligned), else 4-byte stores, kTileSteps lanes per run.
__device__ __forceinline__ void store_tile(const uint32_t* __restrict__ tile, int lane,
                                           long long start, int count, bool vec,
                                           uint32_t* __restrict__ out) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int r = q * (32 / kChunks) + lane / kChunks;
      const int w = 4 * (lane % kChunks);
      const long long dst = __shfl_sync(kFull, start, r);
      const int n = __shfl_sync(kFull, count, r);
      if (w < n) {
        const uint32_t* src = tile + r * kPitch + w;
        *reinterpret_cast<uint4*>(out + dst + w) = make_uint4(src[0], src[1], src[2], src[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kTileSteps; ++q) {
      const int r = q * (32 / kTileSteps) + lane / kTileSteps;
      const int w = lane % kTileSteps;
      const long long dst = __shfl_sync(kFull, start, r);
      const int n = __shfl_sync(kFull, count, r);
      if (w < n) out[dst + w] = tile[r * kPitch + w];
    }
  }
}

// One lane of a planes kernel over a table whose entries are
// next | payload << state_bits: lane g (the thread's global index) scans its
// segment (segment_of) and writes value(v) of the entry v read at body
// position j of window b to out[b*C + j], flat text order, through the
// warp's store tile.  `tiles` is the block's blockDim.x * kPitch shared
// words.  Every lane of the warp must call it (the stores are warp-wide).
// Classes is ClassWords<T> or a type with the same load() and at().
template <typename Classes, typename T, typename Value>
__device__ __forceinline__ void planes_lane(const uint32_t* __restrict__ table,
                                            const T* __restrict__ windows,
                                            int64_t num_windows, int width, int halo,
                                            uint32_t num_classes, uint32_t smask,
                                            int segments, int seg_len, bool vec,
                                            uint32_t* __restrict__ tiles,
                                            uint32_t* __restrict__ out, Value value) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Segment sg = segment_of(g, num_windows, width, halo, segments, seg_len);
  const T* seg = windows + sg.b * width + sg.start;
  uint32_t s = sg.len > 0 ? warm_up(table, seg, halo, num_classes, smask) : 0u;
  seg += halo;
  uint32_t* row = tiles + threadIdx.x * kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * kPitch;
  const long long dst = sg.b * (width - halo) + sg.start;
  const int steps = __reduce_max_sync(kFull, sg.len);
  for (int t0 = 0; t0 < steps; t0 += kTileSteps) {
    const int n = min(kTileSteps, sg.len - t0);  // <= 0 once this lane is done
    Classes cls;
    cls.load(seg + t0, n);
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        const uint32_t v = lookup(table, s, cls.at(t), num_classes);
        row[t] = value(v);
        s = v & smask;
      }
    }
    __syncwarp();
    store_tile(warp_tile, lane, dst + t0, n, vec, out);
    __syncwarp();  // the rows are rewritten by the next tile
  }
}

// Whether a planes kernel's runs (b*C + k*L + a multiple of kTileSteps) are
// 16-byte aligned: C and L multiples of 4 and `out` 16-byte aligned.
inline bool vec_runs(int body, int seg_len, const void* out) {
  return body % 4 == 0 && seg_len % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace tile
