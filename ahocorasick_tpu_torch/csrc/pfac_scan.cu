// Failureless parallel trie walk (PFAC) for Hopper (sm_90a): START-indexed
// depth bitplanes and their count, behind a plain C interface loaded with
// ctypes (ahocorasick_tpu_torch/kernels/build.py builds it,
// kernels/scan_pfac.py binds it).
//
// What it replaces.  The JAX package's cross-check walks, two lax loops:
// ahocorasick_tpu/ops/scan_pfac2.py pfac2_bitplanes (:163, the
// device_engine="pfac2" engine) and pfac2_count (:201).  The v1 walk
// (ops/scan_pfac.py pfac_bitplanes, the reference tests/test_pfac2.py holds
// v2 against) is csrc/pfac1_scan.cu, which shares nothing with this file.
//
// What it computes.  The walk of start i follows the pure trie (no fail
// links) from the root over cls[i], cls[i + 1], ...: a keyword of length L matches at start
// i iff the walk's state after L classes is a match state, and that sets
// bit (L-1) % 32 of plane word (L-1) / 32 of column i.  v2 (ranked tables,
// ops/scan_pfac2.build_ranked): one load of the k-gram prefix table gives
// the state after k classes and the match bits of depths 1..k (bit
// 28 + j = a match at depth k - j); then one trie_next load per depth,
// a match being `state >= threshold` (own-match states are ranked last).
// A lane stops at dead_state, which absorbs and emits nothing.
//
// What bounds it on the H100.  A walk is a chain of up to d - k dependent
// loads into trie_next (8 MB for the 10k dictionary, 65,536 x 32 padded:
// L2-resident) after one prefix load (78.7 KB there: 27^3 entries); on word
// soup most walks end at the prefix or a step after it (the 10k cell: 0.28
// trie loads a start on average, at most 9).  The byte bound is the classes
// in and the planes out (4 B per start and plane).
//
// v2 (pfac2_planes, pfac2_count) runs pfac_walk.cuh's design: persistent
// blocks whose warps each take a span of starts, a dense prefix pass over
// classes staged in shared memory (and the prefix table there where it
// fits), a warp queue of the walks that go on with lanes that refill from
// it, 16-byte plane stores, and one atomic add a block for the count; the
// launch shape comes from kernels/scan_pfac.launch_shape.  The first v2
// design lives on as pfac_first in bench/scan_variants.cu.  The flat table
// index is 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "pfac_walk.cuh"

namespace {

constexpr int kWalkThreads = 1024;  // v2: kernels/scan_pfac.THREADS
constexpr int kWalkPerLane = 8;  // v2: kernels/scan_pfac.PER_LANE
constexpr int kWalkBlocks = 1;  // v2: kernels/scan_pfac.BLOCKS_PER_SM

}  // namespace

extern "C" {

// trie: uint32[S, stride] ranked; prefix: uint32[A^k]; cls: the padded
// classes, n + depth of them; out: uint32[num_planes, n].  The launch shape
// (grid, span: starts a warp, prefix_shared) is
// kernels/scan_pfac.launch_shape's.
int pfac2_planes(const void* trie, int stride, const void* prefix, int64_t threshold,
                 int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth, int k,
                 int num_classes, int num_planes, int grid, int64_t span, int prefix_shared,
                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pfac::Walk w = pfac::make_walk(trie, stride, prefix, threshold, dead, cls, n, depth, k,
                                       num_classes, num_planes, span, out);
  return pfac::launch<false, kWalkThreads, kWalkPerLane, kWalkBlocks>(w, cls_bytes, prefix_shared != 0,
                                                         static_cast<unsigned>(grid),
                                                         static_cast<cudaStream_t>(stream));
}

// As pfac2_planes without the planes; out: uint64[1], zeroed, the total match
// count.
int pfac2_count(const void* trie, int stride, const void* prefix, int64_t threshold,
                int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth, int k,
                int num_classes, int grid, int64_t span, int prefix_shared, void* out,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pfac::Walk w = pfac::make_walk(trie, stride, prefix, threshold, dead, cls, n, depth, k,
                                       num_classes, (depth + 31) / 32, span, out);
  return pfac::launch<true, kWalkThreads, kWalkPerLane, kWalkBlocks>(w, cls_bytes, prefix_shared != 0,
                                                        static_cast<unsigned>(grid),
                                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
