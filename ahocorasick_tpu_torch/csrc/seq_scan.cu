// Sequential DFA scan from an arbitrary entry state for Hopper (sm_90a),
// behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_dfa.py binds it).
//
// What it replaces.  ahocorasick_tpu/core/stream.py _seqscan_jit `run`
// (:96-141), the lax.scan behind the stream cursors' small feeds, legacy
// resumes, the shortest cursor's restart scan and the row-compressed gold
// branch, in both of its forms (dense table, RowTable); and
// ahocorasick_tpu/ops/scan_dfa.py dfa_states (:26-34), the dense form again.
//
// What it computes.  Arrival states s_1 .. s_N from the entry state s_0:
//     dense:     s_i = table[s_{i-1} * A + c_i]
//     RowTable:  s_i = rows[row_id[s_{i-1}] * A + c_i]
// over int32 tables with row stride A and int32 classes.  The carry to the
// next feed is s_N.
//
// What bounds it on the H100.  Operations, not bytes: the recurrence is one
// dependent chain for an arbitrary s_0 and for the shortest restart table
// (which is not d-synchronizing), so the scan is one thread walking it, and
// each character costs one dependent load (two for a RowTable) through the
// read-only path: an L2 round trip when the table exceeds L1.  The bytes (4 in
// and 4 out per character) would take nanoseconds.  What the design does
// about it: one block; all threads stage a tile of classes into shared memory
// with coalesced loads, thread 0 walks the tile keeping the state in a
// register and overwriting each class with its arrival state, and all threads
// store the tile coalesced, so the chain never waits on the class stream or
// the output stream.  Indices are 64-bit.  The parallel form needs chunked
// state maps stitched by an associative scan (the JAX package's
// ops/stitch.py), a different kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
seq_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ row_id,
           const int32_t* __restrict__ cls, int64_t n, int64_t num_classes, int32_t s0,
           int32_t* __restrict__ out) {
  __shared__ int32_t tile[kTile];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = s0;
  for (int64_t base = 0; base < n; base += kTile) {
    const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
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

}  // namespace

// out int32[n].  `row_id` null selects the dense form (`table` int32[S, A]);
// otherwise `table` is the distinct rows int32[R, A] and `row_id` int32[S].
// Returns cudaGetLastError() after the launch.
extern "C" int seq_states(const void* table, const void* row_id, const void* cls, int64_t n,
                          int num_classes, int s0, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || num_classes < 1 || s0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* rid = static_cast<const int32_t*>(row_id);
  const auto* c = static_cast<const int32_t*>(cls);
  auto* states = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (rid != nullptr) {
    seq_kernel<true><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0, states);
  } else {
    seq_kernel<false><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0, states);
  }
  return static_cast<int>(cudaGetLastError());
}
