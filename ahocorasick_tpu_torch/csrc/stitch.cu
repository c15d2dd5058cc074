// Chunk stitching by state maps for Hopper (sm_90a): the sigma map of every
// chunk, the fold of the maps into each chunk's entry state, and the rescan
// of every chunk from its entry state, behind a plain C interface loaded with
// ctypes (ahocorasick_tpu_torch/kernels/build.py builds it, kernels/stitch.py
// binds it).
//
// What it replaces.  ahocorasick_tpu/ops/stitch.py: chunk_state_maps (:33, a
// lax.scan over the chunk columns carrying a (C, S) lane matrix), entry_states
// (:48, a lax.associative_scan that composes whole maps) and stitched_states
// (:68, a vmapped lax.scan); and the same three loops inside the shard_map
// body of ahocorasick_tpu/parallel/sharding.py sharded_arrival_states
// (:230-253), which is the C = 1 case per shard.
//
// What it computes, over a dense int32[S, A] transition table (row stride A)
// and int32[C, K] classes:
//     state_maps:  sigma[c, s] = the state reached from s over chunk c
//     entry_fold:  entry[0] = s0, entry[c] = sigma[c-1][entry[c-1]]
//     rescan:      states[c, j] = arrival state after class j of chunk c,
//                  walking from entry[c]
// so that rescan(table, cls, entry_fold(state_maps(table, cls), s0)) equals
// the one sequential scan of the flattened classes from s0, bit for bit.
//
// What bounds them on the H100.  state_maps by operations: C*K*S dependent
// table lookups (S lanes of work per character), each an L1/L2 round trip;
// its bytes (4*C*K classes in, 4*C*S states out) are small beside that.  The
// design: one thread per (chunk, entry state) lane with the state in a
// register; a block's lanes belong to one chunk, whose classes go through
// shared memory in tiles with coalesced loads, so every lane of the block
// reads one class per step from shared memory and only the table lookup is on
// the chain.  A d-synchronizing table brings all lanes of a chunk to one
// state after d characters, and from there a warp's 32 lookups are one
// address.  entry_fold is a latency chain of C dependent loads (4*C bytes
// out): one thread walks it.  The JAX code composes whole maps in log depth
// because a TPU has no cheap serial chain; the contract is only the entry
// vector, and a log-depth composition is later speed work.  rescan is the
// sequential-scan kernel's loop (seq_scan.cu) once per chunk: bytes are
// 8*C*K, but each chunk is one dependent chain, so one block per chunk stages
// tiles as seq_kernel does and its thread 0 walks; throughput comes only from
// chunks in flight.  All flat indices are 64-bit: C*S and S*A pass 2**31 at
// the 1M-keyword dictionary.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMapThreads = 256;
constexpr int kMapTile = 1024;
constexpr int kScanThreads = 128;
constexpr int kScanTile = 1024;

__global__ void __launch_bounds__(kMapThreads)
maps_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
            int64_t chunk_len, int64_t num_states, int64_t num_classes,
            int64_t blocks_per_chunk, int32_t* __restrict__ sigma) {
  __shared__ int32_t tile[kMapTile];
  const int64_t block = blockIdx.x;
  const int64_t chunk = block / blocks_per_chunk;
  const int64_t lane = (block % blocks_per_chunk) * kMapThreads + threadIdx.x;
  const int32_t* row = cls + chunk * chunk_len;
  const bool live = lane < num_states;
  int32_t s = live ? static_cast<int32_t>(lane) : 0;
  for (int64_t base = 0; base < chunk_len; base += kMapTile) {
    const int len = static_cast<int>(chunk_len - base < kMapTile ? chunk_len - base : kMapTile);
    for (int i = threadIdx.x; i < len; i += kMapThreads) tile[i] = row[base + i];
    __syncthreads();
    if (live) {
      for (int i = 0; i < len; ++i)
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile[i]));
    }
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
  if (live) sigma[chunk * num_states + lane] = s;
}

__global__ void fold_kernel(const int32_t* __restrict__ sigma, int64_t num_chunks,
                            int64_t num_states, int32_t s0, int32_t* __restrict__ entry) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int32_t s = s0;
  for (int64_t c = 0; c < num_chunks; ++c) {
    entry[c] = s;
    if (c + 1 < num_chunks) s = __ldg(sigma + (c * num_states + s));
  }
}

__global__ void __launch_bounds__(kScanThreads)
rescan_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
              const int32_t* __restrict__ entry, int64_t chunk_len, int64_t num_classes,
              int32_t* __restrict__ out) {
  __shared__ int32_t tile[kScanTile];
  const int64_t chunk = blockIdx.x;
  const int32_t* row = cls + chunk * chunk_len;
  int32_t* orow = out + chunk * chunk_len;
  int32_t s = entry[chunk];  // thread 0 carries it across the tiles
  for (int64_t base = 0; base < chunk_len; base += kScanTile) {
    const int len = static_cast<int>(chunk_len - base < kScanTile ? chunk_len - base : kScanTile);
    for (int i = threadIdx.x; i < len; i += kScanThreads) tile[i] = row[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) {
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile[i]));
        tile[i] = s;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kScanThreads) orow[base + i] = tile[i];
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
}

constexpr int64_t kMaxGrid = 2147483647;  // blocks along x

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types and launches
// only non-empty work (num_chunks >= 1; chunk_len may be 0).

// sigma int32[num_chunks, num_states].  `table` is int32[num_states,
// num_classes] (the row stride is num_classes), `cls` int32[num_chunks,
// chunk_len].
extern "C" int state_maps(const void* table, const void* cls, int64_t num_chunks,
                          int64_t chunk_len, int64_t num_states, int num_classes, void* sigma,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 0 || num_states < 1 || num_classes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = (num_states + kMapThreads - 1) / kMapThreads;
  if (per > kMaxGrid / num_chunks) return static_cast<int>(cudaErrorInvalidValue);
  maps_kernel<<<static_cast<unsigned>(per * num_chunks), kMapThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(cls), chunk_len,
      num_states, num_classes, per, static_cast<int32_t*>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// entry int32[num_chunks] from sigma int32[num_chunks, num_states].
extern "C" int entry_fold(const void* sigma, int64_t num_chunks, int64_t num_states, int s0,
                          void* entry, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || num_states < 1 || s0 < 0 || s0 >= num_states)
    return static_cast<int>(cudaErrorInvalidValue);
  fold_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sigma), num_chunks, num_states, s0,
      static_cast<int32_t*>(entry));
  return static_cast<int>(cudaGetLastError());
}

// out int32[num_chunks, chunk_len]: chunk c walked from entry[c].
extern "C" int rescan(const void* table, const void* cls, const void* entry, int64_t num_chunks,
                      int64_t chunk_len, int num_classes, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || num_chunks > kMaxGrid || chunk_len < 1 || num_classes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rescan_kernel<<<static_cast<unsigned>(num_chunks), kScanThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(entry), chunk_len, num_classes, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
