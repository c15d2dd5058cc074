// Failureless parallel trie walk (PFAC) for Hopper (sm_90a): START-indexed
// depth bitplanes and their count, behind a plain C interface loaded with
// ctypes (ahocorasick_tpu_torch/kernels/build.py builds it,
// kernels/scan_pfac.py binds it).
//
// What it replaces.  The JAX package's cross-check walks, three lax loops:
// ahocorasick_tpu/ops/scan_pfac2.py pfac2_bitplanes (:163, the
// device_engine="pfac2" engine) and pfac2_count (:201), and the v1 walk
// ops/scan_pfac.py pfac_bitplanes (:74), the reference tests/test_pfac2.py
// holds v2 against.
//
// What it computes.  Thread i walks the pure trie (no fail links) from the
// root over cls[i], cls[i + 1], ...: a keyword of length L matches at start
// i iff the walk's state after L classes is a match state, and that sets
// bit (L-1) % 32 of plane word (L-1) / 32 of column i.  v2 (ranked tables,
// ops/scan_pfac2.build_ranked): one load of the k-gram prefix table gives
// the state after k classes and the match bits of depths 1..k (bit
// 28 + j = a match at depth k - j); then one trie_next load per depth,
// a match being `state >= threshold` (own-match states are ranked last).
// v1: trie_next from the root and an is_match lookup per depth, no prefix.
// A lane stops at dead_state, which absorbs and emits nothing.  Modes: v2 planes, v2 count (a per-thread
// popcount, a block reduction and one 64-bit atomic add per block), v1 planes.
//
// What bounds it on the H100.  Each lane is a chain of up to d - k dependent
// loads into trie_next (8 MB for the 10k dictionary, 65,536 x 32 padded:
// L2-resident), most lanes ending within a few steps at the dead state; the
// byte bound is the classes in and the planes out (4 B per lane and plane).
// Each thread writes its own column word of each plane, so neighbouring
// threads store to neighbouring words (coalesced); the classes are read at
// i + kk, so a warp's reads of one depth are coalesced too.  The flat table
// index is 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStateBits = 28;  // ops/scan_pfac2._STATE_BITS
constexpr uint32_t kStateMask = (1u << kStateBits) - 1u;

enum Mode { kV2Planes = 0, kV2Count = 1, kV1Planes = 2 };

template <typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
    pfac_kernel(const uint32_t* __restrict__ trie, int stride, const uint32_t* __restrict__ prefix,
                const uint8_t* __restrict__ is_match, uint32_t threshold, uint32_t dead,
                const C* __restrict__ cls, int64_t n, int depth, int k, uint32_t num_classes,
                int num_planes, uint32_t* __restrict__ planes,
                unsigned long long* __restrict__ count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t pop = 0;
  if (i < n) {
    const C* c = cls + i;
    uint32_t word = 0;
    uint32_t st;
    int kk;
    if (kMode == kV1Planes) {
      st = __ldg(trie + static_cast<uint32_t>(c[0]));  // row 0: the root
      word = is_match[st] ? 1u : 0u;
      kk = 1;
    } else {
      uint32_t gram = c[0];
      for (int j = 1; j < k; ++j) gram = gram * num_classes + c[j];
      const uint32_t packed = __ldg(prefix + gram);
      st = packed & kStateMask;
      const uint32_t hist = packed >> kStateBits;
      for (int d = 1; d <= k; ++d) word |= ((hist >> (k - d)) & 1u) << (d - 1);
      kk = k;
    }
    int plane = 0;
    for (; kk < depth && st != dead; ++kk) {
      if ((kk >> 5) != plane) {  // depths rise by one: plane by plane, in order
        if (kMode == kV2Count) {
          pop += __popc(word);
        } else {
          planes[static_cast<int64_t>(plane) * n + i] = word;
        }
        word = 0;
        plane = kk >> 5;
      }
      st = __ldg(trie + static_cast<uint64_t>(st) * stride + static_cast<uint32_t>(c[kk]));
      const bool hit = kMode == kV1Planes ? is_match[st] != 0 : st >= threshold;
      word |= static_cast<uint32_t>(hit) << (kk & 31);
    }
    if (kMode == kV2Count) {
      pop += __popc(word);
    } else {
      planes[static_cast<int64_t>(plane) * n + i] = word;
      for (int p = plane + 1; p < num_planes; ++p) planes[static_cast<int64_t>(p) * n + i] = 0u;
    }
  }
  if (kMode == kV2Count) {
    // Every thread reaches the reduction: lanes past n add 0.
    for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
    __shared__ uint32_t warp_sums[kThreads / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = pop;
    __syncthreads();
    if (warp == 0) {
      pop = lane < kThreads / 32 ? warp_sums[lane] : 0u;
      for (int off = 16; off > 0; off >>= 1) pop += __shfl_down_sync(0xffffffffu, pop, off);
      if (lane == 0 && pop != 0u) atomicAdd(count, static_cast<unsigned long long>(pop));
    }
  }
}

template <typename C>
void launch_mode(int mode, unsigned grid, cudaStream_t st, const uint32_t* trie, int stride,
                 const uint32_t* prefix, const uint8_t* is_match, uint32_t threshold,
                 uint32_t dead, const C* cls, int64_t n, int depth, int k, uint32_t a,
                 int num_planes, void* out) {
  auto* planes = static_cast<uint32_t*>(out);
  auto* count = static_cast<unsigned long long*>(out);
  if (mode == kV2Planes) {
    pfac_kernel<C, kV2Planes><<<grid, kThreads, 0, st>>>(trie, stride, prefix, is_match, threshold,
                                                         dead, cls, n, depth, k, a, num_planes,
                                                         planes, count);
  } else if (mode == kV2Count) {
    pfac_kernel<C, kV2Count><<<grid, kThreads, 0, st>>>(trie, stride, prefix, is_match, threshold,
                                                        dead, cls, n, depth, k, a, num_planes,
                                                        planes, count);
  } else {
    pfac_kernel<C, kV1Planes><<<grid, kThreads, 0, st>>>(trie, stride, prefix, is_match, threshold,
                                                         dead, cls, n, depth, k, a, num_planes,
                                                         planes, count);
  }
}

int launch(int mode, const void* trie, int stride, const void* prefix, const void* is_match,
           int64_t threshold, int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth,
           int k, int num_classes, int num_planes, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || stride < 1 || depth < 1 || num_planes < (depth + 31) / 32 ||
      (mode != kV1Planes && (k < 1 || k > depth))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint32_t*>(trie);
  const auto* p = static_cast<const uint32_t*>(prefix);
  const auto* m = static_cast<const uint8_t*>(is_match);
  const auto thr = static_cast<uint32_t>(threshold);
  const auto dd = static_cast<uint32_t>(dead);
  const auto a = static_cast<uint32_t>(num_classes);
  if (cls_bytes == 1) {
    launch_mode(mode, grid, st, t, stride, p, m, thr, dd, static_cast<const uint8_t*>(cls), n,
                depth, k, a, num_planes, out);
  } else if (cls_bytes == 2) {
    launch_mode(mode, grid, st, t, stride, p, m, thr, dd, static_cast<const uint16_t*>(cls), n,
                depth, k, a, num_planes, out);
  } else if (cls_bytes == 4) {
    launch_mode(mode, grid, st, t, stride, p, m, thr, dd, static_cast<const int32_t*>(cls), n,
                depth, k, a, num_planes, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// trie: uint32[S, stride] ranked; prefix: uint32[A^k]; cls: the padded
// classes, n + depth of them; out: uint32[num_planes, n].
int pfac2_planes(const void* trie, int stride, const void* prefix, int64_t threshold,
                 int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth, int k,
                 int num_classes, int num_planes, void* out, int device, void* stream) {
  return launch(kV2Planes, trie, stride, prefix, nullptr, threshold, dead, cls, cls_bytes, n,
                depth, k, num_classes, num_planes, out, device, stream);
}

// As pfac2_planes; out: uint64[1], zeroed, the total match count.
int pfac2_count(const void* trie, int stride, const void* prefix, int64_t threshold,
                int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth, int k,
                int num_classes, void* out, int device, void* stream) {
  return launch(kV2Count, trie, stride, prefix, nullptr, threshold, dead, cls, cls_bytes, n,
                depth, k, num_classes, (depth + 31) / 32, out, device, stream);
}

// trie: uint32[S, stride]; is_match: uint8[S]; out: uint32[num_planes, n].
int pfac1_planes(const void* trie, int stride, const void* is_match, int64_t dead,
                 const void* cls, int cls_bytes, int64_t n, int depth, int num_planes, void* out,
                 int device, void* stream) {
  return launch(kV1Planes, trie, stride, nullptr, is_match, 0, dead, cls, cls_bytes, n, depth, 0,
                0, num_planes, out, device, stream);
}

}  // extern "C"
