// Row-sharded packed-DFA lane scan for Hopper (sm_90a): the table-sharded
// scanner's device loop, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, kernels/table_sharded.py
// binds it).
//
// What it replaces.  The shard_map body of ahocorasick_tpu/parallel/
// sharding.py:321 _table_sharded_build (run :368, body :373, gather :377):
// the packed table uint32[S, A] (next | payload << state_bits) is cut into
// n_model contiguous row slices of rows_per rows, one per device of the model
// axis; per character every device looks up its own slice for the lanes whose
// state falls into it, contributes 0 for the others, and a psum over the
// model axis yields the full word.  The row gather with a one-hot select over
// A and the collective per character are how a TPU does a lookup; neither is
// carried over.
//
// What it computes.  Thread b scans window b of `width` classes from the
// root (state 0): `halo` warm-up steps that keep only the state, then the
// body, C = width - halo positions.  Per character the owner of state s is
// shard k = s / rows_per and the word is shards[k][(s - k * rows_per) * A + c]:
// exactly one shard owns s, so this equals the masked sum over the shards.  A
// state past the last shard's rows reads 0, as every shard would contribute.
// By mode, per body step with v the word and sb = state_bits:
//   0 count         popcount(v >> sb) summed into one uint64
//   1 count_packed  v >> sb summed into one uint64
//   2 planes        out[b * C + j] = v >> sb
//   3 hotstate      out[b * C + j] = v where v >> sb != 0, else 0
//   4 raw           out[b * C + j] = v
// (flat text order).  The next state is v & ((1 << sb) - 1).
//
// Where the shards live.  `shards` is a device array of n_model base
// pointers, each shard a separate allocation.  They may all lie on the
// scanning device (the only form that has been run: one H100), or on other
// GPUs of the host: the launcher maps each owner with
// cudaDeviceEnablePeerAccess and fails where a peer cannot be mapped.  The
// peer form is unverified.
//
// What bounds it on the H100.  As the single-table scans: every character is
// one table load whose address depends on the previous load, so a lane is a
// chain of dependent loads and throughput comes from lanes in flight.  Beside
// them this kernel pays one more dependent load per character for the shard's
// base pointer (n_model pointers, L1-resident) and an integer division by
// rows_per.  What the design does about it: the state lives in a register,
// pointers and table are read through the read-only path, the flat index is
// 64-bit (a shard of the 1M-keyword table holds 14.7 M words, the whole
// 117.6 M), counts accumulate in 64-bit registers with one atomic per block,
// and each output word is written once.  Left for later work: the pointer
// array in shared memory or constant memory, a multiply-shift in place of the
// division, and the levers of the single-table scans (coalesced window loads
// and plane stores, more lanes per thread).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCount = 0, kCountPacked = 1, kPlanes = 2, kHotstate = 3, kRaw = 4;

struct Shards {
  const uint32_t* const* base;  // n_model shard base pointers
  uint32_t n_model;
  uint32_t rows_per;
  uint32_t stride;  // A, the row stride of every shard
};

template <typename T>
__device__ __forceinline__ uint32_t lookup(const Shards& t, uint32_t s, T c) {
  const uint32_t k = s / t.rows_per;
  if (k >= t.n_model) return 0u;  // no shard owns s: every shard contributes 0
  const uint32_t rel = s - k * t.rows_per;
  // __ldg has no pointer overload: the pointer is read as its 64 bits.
  const auto* shard = reinterpret_cast<const uint32_t*>(
      __ldg(reinterpret_cast<const unsigned long long*>(t.base) + k));
  return __ldg(shard + (static_cast<uint64_t>(rel) * t.stride + static_cast<uint32_t>(c)));
}

// State after the halo, from the root.
template <typename T>
__device__ __forceinline__ uint32_t warm_up(const Shards& t, const T* __restrict__ row,
                                            int halo, uint32_t smask) {
  uint32_t s = 0;  // the root (compiler invariant)
  for (int i = 0; i < halo; ++i) s = lookup(t, s, row[i]) & smask;
  return s;
}

// Adds every thread's value to *out with one atomic per block.  Every thread
// of the block must call it.
__device__ __forceinline__ void block_add(unsigned long long v, unsigned long long* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0ull) atomicAdd(out, v);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    count_kernel(Shards t, const T* __restrict__ windows, int64_t num_windows, int width,
                 int halo, int state_bits, unsigned long long* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long total = 0;
  if (b < num_windows) {
    const T* row = windows + b * width;
    const uint32_t smask = (1u << state_bits) - 1u;
    uint32_t s = warm_up(t, row, halo, smask);
    for (int i = halo; i < width; ++i) {
      const uint32_t v = lookup(t, s, row[i]);
      const uint32_t hi = v >> state_bits;
      total += MODE == kCount ? static_cast<uint32_t>(__popc(hi)) : hi;
      s = v & smask;
    }
  }
  block_add(total, out);  // lanes past num_windows add 0
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    plane_kernel(Shards t, const T* __restrict__ windows, int64_t num_windows, int width,
                 int halo, int state_bits, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  const uint32_t smask = (1u << state_bits) - 1u;
  uint32_t s = warm_up(t, row, halo, smask);
  uint32_t* dst = out + b * (width - halo);
  for (int i = halo; i < width; ++i) {
    const uint32_t v = lookup(t, s, row[i]);
    const uint32_t hi = v >> state_bits;
    dst[i - halo] = MODE == kPlanes ? hi : MODE == kHotstate ? (hi != 0u ? v : 0u) : v;
    s = v & smask;
  }
}

template <typename T>
int launch(const Shards& t, const void* windows, int64_t num_windows, int width, int halo,
           int state_bits, int mode, void* out, cudaStream_t st) {
  const auto* win = static_cast<const T*>(windows);
  const auto grid = static_cast<unsigned>((num_windows + kThreads - 1) / kThreads);
  auto* total = static_cast<unsigned long long*>(out);
  auto* plane = static_cast<uint32_t*>(out);
  switch (mode) {
    case kCount:
      count_kernel<T, kCount><<<grid, kThreads, 0, st>>>(t, win, num_windows, width, halo,
                                                         state_bits, total);
      break;
    case kCountPacked:
      count_kernel<T, kCountPacked><<<grid, kThreads, 0, st>>>(t, win, num_windows, width,
                                                               halo, state_bits, total);
      break;
    case kPlanes:
      plane_kernel<T, kPlanes><<<grid, kThreads, 0, st>>>(t, win, num_windows, width, halo,
                                                          state_bits, plane);
      break;
    case kHotstate:
      plane_kernel<T, kHotstate><<<grid, kThreads, 0, st>>>(t, win, num_windows, width, halo,
                                                            state_bits, plane);
      break;
    case kRaw:
      plane_kernel<T, kRaw><<<grid, kThreads, 0, st>>>(t, win, num_windows, width, halo,
                                                       state_bits, plane);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Maps the memory of every owner other than `device` into `device`'s address
// space.  An owner that cannot be mapped is an error: the scan has no other
// way to reach its rows.
cudaError_t map_peers(const int* owners, int n_model, int device) {
  for (int k = 0; k < n_model; ++k) {
    const int owner = owners[k];
    if (owner == device) continue;
    bool seen = false;
    for (int j = 0; j < k; ++j) seen = seen || owners[j] == owner;
    if (seen) continue;
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, device, owner);
    if (err != cudaSuccess) return err;
    if (!can) return cudaErrorPeerAccessUnsupported;
    err = cudaDeviceEnablePeerAccess(owner, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // mapped by an earlier call: clear the error
    } else if (err != cudaSuccess) {
      return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = the launch was accepted),
// or the error that kept it from launching.  The caller validates shapes and
// types.  `shards` is a device array, on `device`, of n_model pointers to
// uint32[rows_per * stride] shards; `owners` is a host array of the n_model
// device indices the shards lie on.  window_bytes selects the uint8, uint16
// or int32 window instantiation.  `out` is one zeroed uint64 for modes 0 and
// 1, and uint32[num_windows * (width - halo)] for modes 2 to 4.
extern "C" int table_sharded_scan(const void* shards, const int* owners, int n_model,
                                  int64_t rows_per, int stride, const void* windows,
                                  int window_bytes, int64_t num_windows, int width,
                                  int halo, int state_bits, int mode, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_model < 1 || rows_per < 1 || rows_per > 0xffffffffLL || stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = map_peers(owners, n_model, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shards t{static_cast<const uint32_t* const*>(shards), static_cast<uint32_t>(n_model),
                 static_cast<uint32_t>(rows_per), static_cast<uint32_t>(stride)};
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    return launch<uint8_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  }
  if (window_bytes == 2) {
    return launch<uint16_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  }
  if (window_bytes == 4) {
    return launch<int32_t>(t, windows, num_windows, width, halo, state_bits, mode, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
