// Stride-2 row-DFA lane scan for Hopper (sm_90a): match count and
// END-indexed emit planes, two characters per dependent table load, behind a
// plain C interface loaded with ctypes (ahocorasick_tpu_torch/kernels/build.py
// builds it, kernels/scan_rowdfa.py binds it).
//
// What it replaces.  The stride-2 XLA lane scans of the JAX package,
// ahocorasick_tpu/ops/scan_rowdfa.py rowdfa_count (:248) and
// rowdfa_emit_planes (:286), which gather row s*A + c0 of the table and
// select column c1 with a one-hot reduce.
//
// What it computes.  The table (ops/scan_rowdfa.build_rowdfa) has A + 1
// columns per row (s, c0): column c1 < A holds  state2 | emit2 << state_bits
// (the state and emit mask after c0 then c1), column A holds emit1 (the emit
// mask after c0 alone).  Thread b scans window b: from the root (state 0) it
// warms up over the even `halo` of left context, pair by pair, keeping the
// state only, then steps over the body pair by pair.  The count kernel sums
// popcount(emit1) + popcount(emit2); the planes kernel writes emit1 to body
// position 2t and emit2 to 2t + 1 of out[b*C ...], C = W - halo, which is
// flat text order, the layout of packed_scan_planes.
//
// What bounds it on the H100.  As for the packed scan (packed_scan.cu), each
// lane is a chain of dependent loads whose address depends on the previous
// load's result: at the main path's 65,536 windows of 12 + 512 classes the
// card is latency-bound and under-occupied, with a byte bound of the windows
// in (and 4 B per position out for planes).  What this design does about it:
// it halves the chain to C/2 dependent loads per window.  The two loads of a
// step (column c1 and column A of the same row) are independent and issued
// together, so a step costs one round trip.  The price is the table's size,
// S*A*(A+1)*4 B: where it outgrows the 50 MB L2, each step waits on device
// memory instead (ops/scan_rowdfa.pick_engine gives the measured timings).
// The flat index is 64-bit (a 10k-keyword table has 38 M entries, a forced
// one up to 2^28), counts are reduced in-warp and in-block with one 64-bit
// atomic per block, and the planes kernel stores each pair as one 8-byte
// word.  Left for later work, as for the packed scan: staging window tiles in
// shared memory and coalescing the window loads and plane stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The word of row (s, c0), column col: table[(s*A + c0)*(A + 1) + col].
__device__ __forceinline__ uint64_t row_base(uint32_t s, uint32_t c0, uint32_t num_classes) {
  return (static_cast<uint64_t>(s) * num_classes + c0) * (num_classes + 1u);
}

template <typename T>
__device__ __forceinline__ uint32_t warm_up2(const uint32_t* __restrict__ table,
                                             const T* __restrict__ row, int halo,
                                             uint32_t num_classes, uint32_t smask) {
  uint32_t s = 0;  // the root (compiler invariant)
  for (int t = 0; t < halo; t += 2) {
    s = __ldg(table + row_base(s, row[t], num_classes) + row[t + 1]) & smask;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, uint32_t num_classes,
                  int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = warm_up2(table, row, halo, num_classes, smask);
    for (int t = halo; t < width; t += 2) {
      const uint32_t* r = table + row_base(s, row[t], num_classes);
      const uint32_t w = __ldg(r + row[t + 1]);
      const uint32_t e1 = __ldg(r + num_classes);
      pop += __popc(w >> state_bits) + __popc(e1);
      s = w & smask;
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
    planes2_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                   int64_t num_windows, int width, int halo, uint32_t num_classes,
                   int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = warm_up2(table, row, halo, num_classes, smask);
  // C and the body offset are even, so each pair is an aligned 8-byte word.
  uint2* dst = reinterpret_cast<uint2*>(out + b * (width - halo));
  for (int t = halo; t < width; t += 2) {
    const uint32_t* r = table + row_base(s, row[t], num_classes);
    const uint32_t w = __ldg(r + row[t + 1]);
    const uint32_t e1 = __ldg(r + num_classes);
    dst[(t - halo) >> 1] = make_uint2(e1, w >> state_bits);
    s = w & smask;
  }
}

unsigned grid_for(int64_t num_windows) {
  return static_cast<unsigned>((num_windows + kThreads - 1) / kThreads);
}

template <typename Out, template <typename> class Launch>
int launch(const void* table, const void* windows, int window_bytes, int64_t num_windows,
           int width, int halo, int num_classes, int state_bits, void* out, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (halo % 2 != 0 || (width - halo) % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* dst = static_cast<Out*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  const auto a = static_cast<uint32_t>(num_classes);
  if (window_bytes == 1) {
    Launch<uint8_t>::run(grid, st, tab, static_cast<const uint8_t*>(windows), num_windows,
                         width, halo, a, state_bits, dst);
  } else if (window_bytes == 2) {
    Launch<uint16_t>::run(grid, st, tab, static_cast<const uint16_t*>(windows), num_windows,
                          width, halo, a, state_bits, dst);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct Count2 {
  static void run(unsigned grid, cudaStream_t st, const uint32_t* tab, const T* w, int64_t n,
                  int width, int halo, uint32_t a, int sb, unsigned long long* out) {
    count2_kernel<T><<<grid, kThreads, 0, st>>>(tab, w, n, width, halo, a, sb, out);
  }
};

template <typename T>
struct Planes2 {
  static void run(unsigned grid, cudaStream_t st, const uint32_t* tab, const T* w, int64_t n,
                  int width, int halo, uint32_t a, int sb, uint32_t* out) {
    planes2_kernel<T><<<grid, kThreads, 0, st>>>(tab, w, n, width, halo, a, sb, out);
  }
};

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted), or cudaErrorInvalidValue for an odd halo or body.
// The caller validates shapes and types; window_bytes selects the uint8 or
// uint16 window instantiation.  `out` is one zeroed uint64 for the count,
// and uint32[num_windows * (width - halo)] for planes.
extern "C" int rowdfa2_count(const void* table, const void* windows, int window_bytes,
                             int64_t num_windows, int width, int halo, int num_classes,
                             int state_bits, void* out, int device, void* stream) {
  return launch<unsigned long long, Count2>(table, windows, window_bytes, num_windows, width,
                                            halo, num_classes, state_bits, out, device, stream);
}

extern "C" int rowdfa2_planes(const void* table, const void* windows, int window_bytes,
                              int64_t num_windows, int width, int halo, int num_classes,
                              int state_bits, void* out, int device, void* stream) {
  return launch<uint32_t, Planes2>(table, windows, window_bytes, num_windows, width, halo,
                                   num_classes, state_bits, out, device, stream);
}
