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
// What it computes.  Lane g of a grid of num_windows * K lanes scans
// segment k = g % K of window b = g / K: body positions [k*L, min((k+1)*L,
// C)) of the window's C = width - halo, warmed from the root (state 0) over
// the `halo` classes just before it, which is exact because the packed
// automaton is halo-synchronizing (K = 1 where halo = 0; the wrapper fixes K
// and L by kernels/scan_block.py segments, the counts under
// COUNT_MAX_LANES, the planes modes under MAX_LANES, and the plain twin takes
// the same segments).  Per character the owner of state s is shard k = s /
// rows_per and the word is shards[k][(s - k * rows_per) * A + c]: exactly
// one shard owns s, so this equals the masked sum over the shards.  A state
// past the last shard's rows reads 0, as every shard would contribute.  By
// mode, per body step with v the word and sb = state_bits:
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
// What bounds it on the H100.  As the single-table scans (packed_scan.cu,
// huge_scan.cu): every character is one table load whose address depends on
// the previous load, so a lane is a chain of dependent loads, an L2 round
// trip a step on the 10k table and a device-memory one on the 1M table, and
// throughput comes from lanes in flight.  The byte bound at the main path's
// 65,536 windows of 12 + 512 classes is 0.010 ms for the counts and 0.050 ms
// for the planes.  The kernels are the single-table kernels' lane loops
// (tile.cuh count_lane and planes_lane) over the Shards table type: classes
// read a 32-bit word at a time (no class load in the chain), K lanes per
// window so each chain is shorter, and, for the planes modes, the warp's
// 16-step shared-memory store tile that leaves as whole sectors.  What the
// row sharding adds to each step of the chain, and what the design does
// about it:
//   * The owner's index k = s / rows_per, an integer division (a
//     subroutine of about 20 instructions on the card) in the first design.
//     Here it is one 32 x 32 + 64-bit multiply-add and a shift, (s * magic +
//     add) >> shift, from constants the host computes once per table
//     (kernels/table_sharded.py division_constants), exact for every 32-bit
//     state: the round-up or the round-down method (Robison, "N-bit
//     unsigned division via N-bit multiply-add", 2005) by which one is exact
//     for rows_per, 2**32 - 1 over 2**floor(log2 rows_per) for a power of two.
//   * The shard's base pointer, a global load the first design issued per
//     step.  Each block copies the n_model pointers into shared memory when
//     it starts (a lane's shard varies from lane to lane, so the pointers are
//     not uniform and constant memory would serialize), so the step's extra
//     load is a shared-memory one.  The stage is dynamic shared memory beside
//     the store tile, within the 48 KiB a block gets without opting in:
//     kMaxShards pointers, far past any host's mesh; the wrapper refuses
//     more.
// The state lives in a register, the tables are read through the read-only
// path (__ldg), the flat index is 64-bit (a shard of the 1M-keyword table
// holds 14.7 M words, the whole 117.6 M), counts accumulate in 64-bit
// registers with one atomic per block, and each output word is written once.
// The first design (one thread a window, a class load a step, a 4-byte store
// at the lane's own row stride, the division and the global pointer load in
// the chain) stays in bench/scan_variants.cu for the A/B.  On the card
// (chip_smoke.py's "time table_sharded_scan" and "ab table_sharded" lines;
// NVIDIA H100 80GB HBM3, 700 W) the 10k table in 8 shards at 65,536 x 524
// windows took 0.213 ms for the planes (the first design 0.768; the
// single-table planes 0.187) and 0.102 ms for the count (the single-table
// count 0.077), and the 1M table in 8 shards what the single-table kernels
// take (0.389 and 0.432 ms against 0.391 and 0.432): the owner's lookup
// costs the 10k table's L2-latency chain 14-32% and is lost in the 1M
// table's device-memory latency.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCount = 0, kCountPacked = 1, kPlanes = 2, kHotstate = 3, kRaw = 4;
// The shard pointers a block stages beside the planes' store tile in the
// 48 KiB of shared memory a block gets without opting in (kernels/
// table_sharded.py MAX_SHARDS).
constexpr int kTileBytes = kThreads * tile::kPitch * 4;
constexpr int kMaxShards = (48 * 1024 - kTileBytes) / 8;  // 3,968

// Row shards: the lane loops' table type.  `base` is the block's
// shared-memory copy of the n_model shard base pointers.
struct Shards {
  static constexpr int kStride = 1;
  const uint32_t* const* base;
  uint32_t n_model;
  uint32_t rows_per;
  uint32_t stride;  // A, the row stride of every shard
  uint32_t magic;   // s / rows_per == (s * magic + add) >> shift
  uint32_t add;
  int shift;

  template <typename T>
  __device__ __forceinline__ uint32_t lookup(uint32_t s, T c) const {
    const auto k = static_cast<uint32_t>((static_cast<uint64_t>(s) * magic + add) >> shift);
    if (k >= n_model) return 0u;  // no shard owns s: every shard contributes 0
    const uint32_t rel = s - k * rows_per;
    return __ldg(base[k] + (static_cast<uint64_t>(rel) * stride + static_cast<uint32_t>(c)));
  }
};

// Copies the n_model pointers of `shards` (a device array) into the block's
// stage and points t at it.  Every thread of the block must call it.
__device__ __forceinline__ void stage_shards(Shards& t, const uint32_t* const* shards) {
  extern __shared__ unsigned long long stage[];
  for (uint32_t k = threadIdx.x; k < t.n_model; k += blockDim.x)
    stage[k] = __ldg(reinterpret_cast<const unsigned long long*>(shards) + k);
  __syncthreads();
  t.base = reinterpret_cast<const uint32_t* const*>(stage);
}

// The lane values of the five modes, by the payload v >> sb.
struct PayloadPopcount {
  static constexpr bool kGather = false;
  int sb;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const { return __popc(v >> sb); }
};

struct Payload {
  static constexpr bool kGather = false;
  int sb;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const { return v >> sb; }
};

struct HotWord {
  static constexpr bool kGather = false;
  int sb;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return (v >> sb) != 0u ? v : 0u;
  }
};

struct RawWord {
  static constexpr bool kGather = false;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const { return v; }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    count_kernel(Shards t, const uint32_t* const* shards, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, int state_bits, int segments,
                 int seg_len, unsigned long long* __restrict__ out) {
  stage_shards(t, shards);
  const uint32_t smask = (1u << state_bits) - 1u;
  unsigned long long total;
  if constexpr (MODE == kCount) {
    // A tile's sum is at most 32 x 32 popcounts: 32 bits hold it.
    total = tile::count_lane<uint32_t>(t, windows, num_windows, width, halo, smask, segments,
                                       seg_len, PayloadPopcount{state_bits});
  } else {
    total = tile::count_lane<unsigned long long>(t, windows, num_windows, width, halo, smask,
                                                 segments, seg_len, Payload{state_bits});
  }
  tile::block_add<kThreads>(total, out);  // lanes past the last window add 0
}

template <typename T, typename Value>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(Shards t, const uint32_t* const* shards, const T* __restrict__ windows,
                  int64_t num_windows, int width, int halo, int state_bits, int segments,
                  int seg_len, bool vec, Value value, uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  stage_shards(t, shards);
  tile::planes_lane<tile::ClassWords<T>>(t, windows, num_windows, width, halo,
                                         (1u << state_bits) - 1u, segments, seg_len, vec, tiles,
                                         out, value);
}

template <typename T>
int launch(const Shards& t, const uint32_t* const* shards, const void* windows,
           int64_t num_windows, int width, int halo, int state_bits, int mode, int segments,
           int seg_len, void* out, cudaStream_t st) {
  const auto* win = static_cast<const T*>(windows);
  const auto grid = static_cast<unsigned>((num_windows * segments + kThreads - 1) / kThreads);
  const size_t smem = sizeof(unsigned long long) * t.n_model;
  auto* total = static_cast<unsigned long long*>(out);
  auto* plane = static_cast<uint32_t*>(out);
  const bool vec = tile::vec_runs(width - halo, seg_len, plane);
  switch (mode) {
    case kCount:
      count_kernel<T, kCount><<<grid, kThreads, smem, st>>>(
          t, shards, win, num_windows, width, halo, state_bits, segments, seg_len, total);
      break;
    case kCountPacked:
      count_kernel<T, kCountPacked><<<grid, kThreads, smem, st>>>(
          t, shards, win, num_windows, width, halo, state_bits, segments, seg_len, total);
      break;
    case kPlanes:
      planes_kernel<T><<<grid, kThreads, smem, st>>>(t, shards, win, num_windows, width, halo,
                                                     state_bits, segments, seg_len, vec,
                                                     Payload{state_bits}, plane);
      break;
    case kHotstate:
      planes_kernel<T><<<grid, kThreads, smem, st>>>(t, shards, win, num_windows, width, halo,
                                                     state_bits, segments, seg_len, vec,
                                                     HotWord{state_bits}, plane);
      break;
    case kRaw:
      planes_kernel<T><<<grid, kThreads, smem, st>>>(t, shards, win, num_windows, width, halo,
                                                     state_bits, segments, seg_len, vec,
                                                     RawWord{}, plane);
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
// uint32[rows_per * stride] shards (at most kMaxShards); `owners` is a host
// array of the n_model device indices the shards lie on.  (magic, add,
// shift) divide a state by rows_per (Shards).  window_bytes selects the
// uint8, uint16 or int32 window instantiation.  `segments` lanes per window,
// `seg_len` body positions each (tile::valid_segments).  `out` is one zeroed
// uint64 for modes 0 and 1, and uint32[num_windows * (width - halo)] for
// modes 2 to 4.
extern "C" int table_sharded_scan(const void* shards, const int* owners, int n_model,
                                  int64_t rows_per, int stride, int64_t magic, int64_t add,
                                  int shift, const void* windows, int window_bytes,
                                  int64_t num_windows, int width, int halo, int state_bits,
                                  int mode, int segments, int seg_len, void* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_model < 1 || n_model > kMaxShards || rows_per < 1 || rows_per > 0xffffffffLL ||
      stride < 1 || magic < 0 || magic > 0xffffffffLL || add < 0 || add > 0xffffffffLL ||
      shift < 32 || shift > 63 ||
      !tile::valid_segments(segments, seg_len, width - halo, halo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = map_peers(owners, n_model, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shards t{nullptr, static_cast<uint32_t>(n_model), static_cast<uint32_t>(rows_per),
                 static_cast<uint32_t>(stride), static_cast<uint32_t>(magic),
                 static_cast<uint32_t>(add), shift};
  const auto* ptrs = static_cast<const uint32_t* const*>(shards);
  auto st = static_cast<cudaStream_t>(stream);
  if (window_bytes == 1) {
    return launch<uint8_t>(t, ptrs, windows, num_windows, width, halo, state_bits, mode,
                           segments, seg_len, out, st);
  }
  if (window_bytes == 2) {
    return launch<uint16_t>(t, ptrs, windows, num_windows, width, halo, state_bits, mode,
                            segments, seg_len, out, st);
  }
  if (window_bytes == 4) {
    return launch<int32_t>(t, ptrs, windows, num_windows, width, halo, state_bits, mode,
                           segments, seg_len, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
