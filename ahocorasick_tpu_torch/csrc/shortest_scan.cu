// Sequential lagged-restart DFA scan of the leftmost-shortest matcher for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_dfa.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_dfa.py shortest_states (jit at
// :37-38), a lax.scan that the JAX package runs for shortest matchers loaded
// from an artifact without their internal AC automaton.
//
// What it computes.  Arrival states s_1 .. s_N of the reference's restart
// loop (ShortestMatchSet.java:200-216): from s_0 = 0 (the root),
//     row = match_len[s] > 0 ? 0 : s;   s = dfa_next[row * A + c]
// over the tables padded as the JAX package pads them (dfa_next
// int32[S_pad, A], match_len int32[S_pad]).  Classes are uint8, uint16 or
// int32.
//
// What bounds it on the H100.  The recurrence is sequential: the state after
// character i decides the row read for character i + 1, so the scan is one
// thread walking the chain, and each character costs two dependent loads
// (match_len[s], then dfa_next[row * A + c]) through the read-only path.
// The main path's table (10k keywords: 65,536 x 32 x 4 B = 8 MB) lives in
// L2, so a character costs about two L2 round trips: roughly a million
// characters per second, whatever the card's width.  What the design does
// about it: the state stays in a register, the flat index is 64-bit, and the
// class and output streams are independent of the chain so their loads and
// stores overlap it.  Making it parallel needs chunked state maps stitched
// by an associative scan (the JAX package's ops/stitch.py), later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void shortest_kernel(const int32_t* __restrict__ dfa_next,
                                const int32_t* __restrict__ match_len,
                                const T* __restrict__ cls, int64_t n,
                                int64_t num_classes, int32_t* __restrict__ out) {
  int32_t s = 0;  // the root
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = __ldg(match_len + s) > 0 ? 0 : s;
    s = __ldg(dfa_next + (static_cast<int64_t>(row) * num_classes + cls[i]));
    out[i] = s;
  }
}

}  // namespace

// out int32[n]; cls_bytes selects the uint8 (1), uint16 (2) or int32 (4)
// class instantiation.  Returns cudaGetLastError() after the launch.
extern "C" int shortest_states(const void* dfa_next, const void* match_len,
                               const void* cls, int cls_bytes, int64_t n,
                               int num_classes, void* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || num_classes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* next = static_cast<const int32_t*>(dfa_next);
  const auto* lens = static_cast<const int32_t*>(match_len);
  auto* states = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (cls_bytes == 1) {
    shortest_kernel<uint8_t><<<1, 1, 0, st>>>(next, lens, static_cast<const uint8_t*>(cls), n,
                                              num_classes, states);
  } else if (cls_bytes == 2) {
    shortest_kernel<uint16_t><<<1, 1, 0, st>>>(next, lens, static_cast<const uint16_t*>(cls), n,
                                               num_classes, states);
  } else if (cls_bytes == 4) {
    shortest_kernel<int32_t><<<1, 1, 0, st>>>(next, lens, static_cast<const int32_t*>(cls), n,
                                              num_classes, states);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
