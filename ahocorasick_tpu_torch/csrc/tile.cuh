// The lane-scan building blocks shared by the planes kernels of
// packed_scan.cu and wwl_scan.cu (their source notes say why each is there):
// a lane's classes read a 32-bit word at a time, and a warp's 16-step store
// tile in shared memory that leaves as whole sectors.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tile {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileSteps = 16;           // body steps per store tile
constexpr int kPitch = kTileSteps + 1;   // words per lane row: 17, an odd bank stride
constexpr int kChunks = kTileSteps / 4;  // 16-byte chunks per run

// The classes of a tile of up to kTileSteps steps, held as the aligned 32-bit
// words that contain them (kPer classes a word) and funnel-shifted into place
// by at().  load() reads no word past the one that holds the tile's last
// class, and none at all for n <= 0: a lane whose row is done loads nothing.
template <typename T>
struct ClassWords {
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  static constexpr int kWords = kTileSteps / kPer;
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

}  // namespace tile
