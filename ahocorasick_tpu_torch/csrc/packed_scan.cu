// Packed-DFA lane scan for Hopper (sm_90a): match count and END-indexed
// emit planes, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_block.py binds it).
//
// What it replaces.  The TPU kernels ahocorasick_tpu/kernels/scan_block.py
// block_count (pallas_call at :152) and block_emit_planes (:209), and the
// XLA lane-scan loops that compute the same two results over the same packed
// table and differ only in how a TPU does the lookup:
// ops/scan_rowdfa.py rowdfa1_count / rowdfa1_emit_planes and
// ops/scan_batched.py batched_count / batched_emit_planes.
//
// What it computes.  Table entry s*A + c is  next | emit << state_bits
// (uint32), where bit L-1 of emit means "a keyword of length L ends here"
// (suffix chain included).  Thread b scans window b: it starts at the root
// (state 0), warms up over the `halo` left-context classes (the automaton
// is halo-synchronizing, so the state converges to the sequential one), then
// steps over the body.  The count kernel sums popcount(emit); the planes
// kernel writes emit for body position j of window b to out[b*C + j],
// C = W - halo, which is flat text order.
//
// What bounds it on the H100.  Every character is one table load whose
// address depends on the previous load (s -> s*A + c): a lane is a chain of
// dependent loads.  The main path's table (10k keywords: 50,352 states x 32
// classes x 4 B = 6.4 MB) is too big for a block's 227 KB of shared memory
// and stays resident in the 50 MB L2, so each step costs one L2 round trip.
// Throughput comes only from lanes in flight.  At the main path's shape
// (65,536 windows of 12 + 512 classes) there are 65,536 threads, about a
// quarter of the 132 SMs x 2,048 resident threads, so the card is
// latency-bound and under-occupied.  What this design does about it: the
// state lives in a register, the table is read through the read-only path
// (__ldg), the flat index is 64-bit, counts are reduced in-warp and
// in-block with one 64-bit atomic per block, and each emit mask is written
// once.  Left for later work: staging small tables in shared memory,
// coalescing the window loads (thread b reads row b at a stride of W
// elements here) and the plane stores, and more lanes per thread to hide
// the load latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ table,
                                           uint32_t s, T c,
                                           uint32_t num_classes) {
  return __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
}

template <typename T>
__device__ __forceinline__ uint32_t warm_up(const uint32_t* __restrict__ table,
                                            const T* __restrict__ row, int halo,
                                            uint32_t num_classes,
                                            uint32_t smask) {
  uint32_t s = 0;  // the root (compiler invariant)
  for (int t = 0; t < halo; ++t) s = lookup(table, s, row[t], num_classes) & smask;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, uint32_t num_classes,
                 int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = warm_up(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; ++t) {
      const uint32_t v = lookup(table, s, row[t], num_classes);
      pop += __popc(v >> state_bits);
      s = v & smask;
    }
  }
  // Every thread reaches the shuffles: lanes past num_windows add 0.
  for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = pop;
  __syncthreads();
  if (warp == 0) {
    pop = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
    if (lane == 0 && pop != 0u) atomicAdd(out, static_cast<unsigned long long>(pop));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = warm_up(table, row, halo, num_classes, smask);
  uint32_t* dst = out + b * (width - halo);
  for (int t = halo; t < width; ++t) {
    const uint32_t v = lookup(table, s, row[t], num_classes);
    dst[t - halo] = v >> state_bits;
    s = v & smask;
  }
}

unsigned grid_for(int64_t num_windows) {
  return static_cast<unsigned>((num_windows + kThreads - 1) / kThreads);
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types; window_bytes
// selects the uint8 or uint16 window instantiation.  `out` is one zeroed
// uint64 for the count, and uint32[num_windows * (width - halo)] for planes.
extern "C" int packed_scan_count(const void* table, const void* windows,
                                 int window_bytes, int64_t num_windows, int width,
                                 int halo, int num_classes, int state_bits,
                                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* total = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, total);
  } else if (window_bytes == 2) {
    count_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_scan_planes(const void* table, const void* windows,
                                  int window_bytes, int64_t num_windows, int width,
                                  int halo, int num_classes, int state_bits,
                                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* planes = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  if (window_bytes == 1) {
    planes_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, planes);
  } else if (window_bytes == 2) {
    planes_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo,
        static_cast<uint32_t>(num_classes), state_bits, planes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
