// Designs of the packed planes kernel that the package does not use, kept
// so that python -m ahocorasick_tpu_torch.bench.planes_stores can time them
// beside csrc/packed_scan.cu's packed_scan_planes on the card.
//
// Each computes exactly packed_scan_planes (the same lanes, segments and
// warm-up; see the source note of csrc/packed_scan.cu) and differs in how a
// lane reads its classes and how its emit words reach device memory:
//   * planes_tile32_bytes: one class load a step, and the shared-memory
//     transpose with a tile of 32 steps (33-word rows: 132 B a lane, so
//     1,536 lanes an SM), runs of 128 bytes, 8 lanes per run.
//   * planes_tile32_words: the same tile, the classes read as aligned 32-bit
//     words like the package's kernel.
//   * planes_bulk: classes as words; each lane keeps 16 emit words in
//     registers, writes them to its own 80-byte shared-memory row with
//     16-byte stores (rows 5 chunks apart, so a quarter-warp's stores hit 8
//     bank groups), and hands the run to the TMA unit as one cp.async.bulk
//     (shared -> global), committed while the lane scans its next tile; the
//     lane waits for the copy to have read its row before it rewrites it.
// All need 16-byte aligned runs (C and L multiples of 4).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ table, uint32_t s, T c,
                                           uint32_t num_classes) {
  return __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
}

template <typename T>
__device__ __forceinline__ uint32_t warm_up(const uint32_t* __restrict__ table,
                                            const T* __restrict__ row, int halo,
                                            uint32_t num_classes, uint32_t smask) {
  uint32_t s = 0;
  for (int t = 0; t < halo; ++t) s = lookup(table, s, row[t], num_classes) & smask;
  return s;
}

// The package's transpose with a tile of kSteps steps; kWordLoads: the
// lane reads its tile's classes as aligned 32-bit words (funnel-shifted into
// place) instead of one load per class.
template <typename T, int kSteps, bool kWordLoads>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                int64_t num_windows, int width, int halo, uint32_t num_classes,
                int state_bits, int segments, int seg_len, uint32_t* __restrict__ out) {
  constexpr int kPitch = kSteps + 1;
  constexpr int kChunks = kSteps / 4;
  constexpr int kPer = 4 / sizeof(T);  // classes per word
  constexpr int kWords = kSteps / kPer;
  __shared__ uint32_t tile[kThreads * kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;
  const int start = static_cast<int>(g - b * segments) * seg_len;
  const int body = width - halo;
  const int len = b < num_windows ? min(seg_len, body - start) : 0;
  const uint32_t smask = (1u << state_bits) - 1u;
  const T* seg = windows + b * width + start;
  uint32_t s = len > 0 ? warm_up(table, seg, halo, num_classes, smask) : 0u;
  seg += halo;
  uint32_t* row = tile + threadIdx.x * kPitch;
  const uint32_t* warp_tile = tile + (threadIdx.x - lane) * kPitch;
  const long long dst = b * body + start;
  const int steps = __reduce_max_sync(kFull, len);
  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    const int n = min(kSteps, len - t0);
    if (kWordLoads) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(seg + t0);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
      const uint32_t shift = static_cast<uint32_t>(a & 3) * 8;
      const int nw = n > 0 ? (static_cast<int>(a & 3) + n * static_cast<int>(sizeof(T)) + 3) / 4
                           : 0;
      uint32_t raw[kWords + 1];
#pragma unroll
      for (int k = 0; k <= kWords; ++k) raw[k] = k < nw ? __ldg(wp + k) : 0u;
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        if (t < n) {
          const uint32_t word = __funnelshift_r(raw[t / kPer], raw[t / kPer + 1], shift);
          const uint32_t c = (word >> (8 * sizeof(T) * (t % kPer))) &
                             ((1u << (8 * sizeof(T))) - 1u);
          const uint32_t v = __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
          row[t] = v >> state_bits;
          s = v & smask;
        }
      }
    } else {
      for (int t = 0; t < n; ++t) {
        const uint32_t v = lookup(table, s, seg[t0 + t], num_classes);
        row[t] = v >> state_bits;
        s = v & smask;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int r = q * (32 / kChunks) + lane / kChunks;
      const int w = 4 * (lane % kChunks);
      const long long d = __shfl_sync(kFull, dst + t0, r);
      const int nr = __shfl_sync(kFull, n, r);
      if (w < nr) {
        const uint32_t* src = warp_tile + r * kPitch + w;
        *reinterpret_cast<uint4*>(out + d + w) = make_uint4(src[0], src[1], src[2], src[3]);
      }
    }
    __syncwarp();
  }
}

constexpr int kStepsBulk = 16;
constexpr int kRowWords = 20;  // 80 bytes: 16-byte aligned, an odd number of chunks

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bulk_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                int64_t num_windows, int width, int halo, uint32_t num_classes,
                int state_bits, int segments, int seg_len, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t rows[kThreads * kRowWords];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;
  const int start = static_cast<int>(g - b * segments) * seg_len;
  const int body = width - halo;
  const int len = b < num_windows ? min(seg_len, body - start) : 0;
  const uint32_t smask = (1u << state_bits) - 1u;
  const T* seg = windows + b * width + start;
  uint32_t s = len > 0 ? warm_up(table, seg, halo, num_classes, smask) : 0u;
  seg += halo;
  uint32_t* row = rows + threadIdx.x * kRowWords;
  const uint32_t row_addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  uint32_t* dst = out + b * body + start;
  constexpr int kPer = 4 / sizeof(T);
  constexpr int kWords = kStepsBulk / kPer;
  for (int t0 = 0; t0 < len; t0 += kStepsBulk) {
    const int n = min(kStepsBulk, len - t0);
    const uintptr_t a = reinterpret_cast<uintptr_t>(seg + t0);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const uint32_t shift = static_cast<uint32_t>(a & 3) * 8;
    const int nw = (static_cast<int>(a & 3) + n * static_cast<int>(sizeof(T)) + 3) / 4;
    uint32_t raw[kWords + 1];
#pragma unroll
    for (int k = 0; k <= kWords; ++k) raw[k] = k < nw ? __ldg(wp + k) : 0u;
    uint32_t e[kStepsBulk];
#pragma unroll
    for (int t = 0; t < kStepsBulk; ++t) {
      e[t] = 0u;
      if (t < n) {
        const uint32_t word = __funnelshift_r(raw[t / kPer], raw[t / kPer + 1], shift);
        const uint32_t c = (word >> (8 * sizeof(T) * (t % kPer))) &
                           ((1u << (8 * sizeof(T))) - 1u);
        const uint32_t v = __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
        e[t] = v >> state_bits;
        s = v & smask;
      }
    }
    // The previous tile's copy must have read the row before it is rewritten.
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < kStepsBulk / 4; ++c)
      reinterpret_cast<uint4*>(row)[c] = make_uint4(e[4 * c], e[4 * c + 1], e[4 * c + 2],
                                                    e[4 * c + 3]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(__cvta_generic_to_global(dst + t0)), "r"(row_addr),
                    "r"(static_cast<uint32_t>(4 * n))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

unsigned grid_for(int64_t lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

template <int kSteps, bool kWordLoads>
struct Tile {
  template <typename T>
  static void launch(unsigned grid, cudaStream_t st, const uint32_t* table, const T* windows,
                     int64_t num_windows, int width, int halo, uint32_t num_classes,
                     int state_bits, int segments, int seg_len, uint32_t* out) {
    tile_kernel<T, kSteps, kWordLoads><<<grid, kThreads, 0, st>>>(
        table, windows, num_windows, width, halo, num_classes, state_bits, segments, seg_len,
        out);
  }
};

struct Bulk {
  template <typename T>
  static void launch(unsigned grid, cudaStream_t st, const uint32_t* table, const T* windows,
                     int64_t num_windows, int width, int halo, uint32_t num_classes,
                     int state_bits, int segments, int seg_len, uint32_t* out) {
    bulk_kernel<T><<<grid, kThreads, 0, st>>>(table, windows, num_windows, width, halo,
                                              num_classes, state_bits, segments, seg_len, out);
  }
};

// The arguments of packed_scan_planes; every design needs 16-byte aligned
// runs ((width - halo) % 4 == 0, seg_len % 4 == 0 or segments == 1).
template <class D>
int run(const void* table, const void* windows, int window_bytes, int64_t num_windows,
        int width, int halo, int num_classes, int state_bits, int segments, int seg_len,
        void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((width - halo) % 4 != 0 || (segments > 1 && seg_len % 4 != 0) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  const auto nc = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    D::template launch<uint8_t>(grid, st, tab, static_cast<const uint8_t*>(windows), num_windows,
                                width, halo, nc, state_bits, segments, seg_len, o);
  } else if (window_bytes == 2) {
    D::template launch<uint16_t>(grid, st, tab, static_cast<const uint16_t*>(windows),
                                 num_windows, width, halo, nc, state_bits, segments, seg_len, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PLANES_ARGS                                                                      \
  const void *table, const void *windows, int window_bytes, int64_t num_windows,          \
      int width, int halo, int num_classes, int state_bits, int segments, int seg_len,    \
      void *out, int device, void *stream
#define PLANES_PASS                                                                      \
  table, windows, window_bytes, num_windows, width, halo, num_classes, state_bits,       \
      segments, seg_len, out, device, stream

extern "C" int planes_tile32_bytes(PLANES_ARGS) { return run<Tile<32, false>>(PLANES_PASS); }
extern "C" int planes_tile32_words(PLANES_ARGS) { return run<Tile<32, true>>(PLANES_PASS); }
extern "C" int planes_bulk(PLANES_ARGS) { return run<Bulk>(PLANES_PASS); }
