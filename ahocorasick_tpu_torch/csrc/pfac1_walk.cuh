// The PFAC v1 walk for Hopper (sm_90a): START-indexed depth bitplanes from
// the unranked trie and its is_match flags.  Included by csrc/pfac1_scan.cu.
//
// What it computes (ahocorasick_tpu/ops/scan_pfac.py:50 pfac_bitplanes).
// Start i walks the pure trie from the root (row 0) over cls[i], cls[i + 1],
// ...; after kk + 1 classes a match state sets bit kk % 32 of plane kk / 32
// of column i.  A walk stops at `dead`, which absorbs and emits nothing.  It
// reads only trie_next, is_match and the classes, as the JAX loop does, and
// none of the v2 walk's tables (pfac_walk.cuh, the ranked trie, the k-gram
// prefix): v1 is the independent walk the tests hold v2 against.
//
// The design.  Persistent blocks (kernels/scan_pfac.pfac1_plan gives the
// grid and whether the tables are staged) first build, once each, from
// trie_next and is_match, where A_pad^2 words fit: the root row and the
// two-level table trie[trie[0][c0]][c1], each entry a state with its match
// flag in bit 31.  A walk's first two steps are then two shared loads (else
// its first is the root read with __ldg), and each later step one trie_next
// load and one is_match byte, both __ldg.  Thread t of a block takes start t of each of
// the block's runs of kThreads starts, grid-stride; a warp's plane words
// leave together (128 contiguous bytes a store) once its walks have ended.
//
// What bounds it.  The trie loads past the staged levels, from L2 at the
// card's rate of random requests: the first design's loads at depths 1 and
// 2 read the root row and the rows of its children, which L1 holds, so
// staging them removes L1 hits and not L2 requests, and any shared memory a
// block keeps is L1 that the hot trie rows lose.  So the kernel stages only
// the two small tables (4.2 KB a block on the 10k dictionary) and keeps the
// first design's walk a thread at full occupancy.  Lanes and tiles of
// starts walked in turn, is_match as bits, a three-level table and two
// walks a thread lost to it on the card (PERF.md, PR 24).

#include <cstdint>

#include <cuda_runtime.h>

namespace pfac1 {

constexpr int kThreads = 512;  // kernels/scan_pfac.V1_THREADS
constexpr int kBlocks = 4;  // an SM's blocks (32 registers): kernels/scan_pfac.V1_BLOCKS_PER_SM
constexpr uint32_t kMatch = 0x80000000u;  // a staged entry's match flag
constexpr uint32_t kState = 0x7fffffffu;

struct Walk {
  const uint32_t* trie;  // uint32[S, stride]
  const uint8_t* is_match;  // bool[>= S]
  const void* cls;  // n + depth padded classes
  uint32_t* planes;  // uint32[num_planes, n]
  int64_t n;
  int64_t states;  // S, the trie's rows
  uint32_t dead;
  int stride, depth, num_planes;
  int two_level;  // the root row and the two-level table staged; else the root read with __ldg
};

__host__ __device__ inline int64_t round16(int64_t bytes) { return (bytes + 15) & ~int64_t{15}; }

// The staged tables' bytes (kernels/scan_pfac.pfac1_smem): the root row,
// then the two-level table, each 16-byte aligned.
__host__ __device__ inline int64_t root_bytes(const Walk& w) {
  return w.two_level ? round16(4 * static_cast<int64_t>(w.stride)) : 0;
}
__host__ __device__ inline int64_t smem_bytes(const Walk& w) {
  const int64_t stride = w.stride;
  return root_bytes(w) + (w.two_level ? round16(4 * stride * stride) : 0);
}

__device__ __forceinline__ uint32_t match_of(const Walk& w, uint32_t s) {
  return static_cast<uint32_t>(__ldg(w.is_match + s) != 0);
}

// The walk of the start whose classes begin at `c`: its first two steps
// from the staged tables, or its first from the root read with __ldg.
template <typename C>
__device__ __forceinline__ void begin(const Walk& w, const uint32_t* s_root, const uint32_t* s_two,
                                      const C* c, uint32_t& st, uint32_t& word, int& kk) {
  const uint32_t c0 = static_cast<uint32_t>(c[0]);
  const uint32_t last = static_cast<uint32_t>(w.stride - 1);  // keeps shared reads in bounds
  kk = 1;
  if (!w.two_level) {
    st = __ldg(w.trie + c0);
    word = match_of(w, st);
    return;
  }
  const uint32_t e = s_root[min(c0, last)];
  st = e & kState;
  word = e >> 31;
  if (w.depth > 1 && st != w.dead) {
    const uint32_t c1 = static_cast<uint32_t>(c[1]);
    const uint32_t e = s_two[min(c0, last) * static_cast<uint32_t>(w.stride) + min(c1, last)];
    st = e & kState;
    word |= (e >> 31) << 1;
    kk = 2;
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads, kBlocks) walk_kernel(const Walk param) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Walk w = param;  // a local copy, passed by reference below
  uint32_t* s_root = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_two = reinterpret_cast<uint32_t*>(smem + root_bytes(w));
  const uint32_t stride = static_cast<uint32_t>(w.stride);
  if (w.two_level) {
    for (uint32_t c = threadIdx.x; c < stride; c += kThreads) {
      const uint32_t s = __ldg(w.trie + c);
      s_root[c] = s | (match_of(w, s) ? kMatch : 0u);
    }
    __syncthreads();
    for (uint32_t e = threadIdx.x; e < stride * stride; e += kThreads) {
      const uint32_t r = s_root[e / stride] & kState;
      const uint32_t s = __ldg(w.trie + (static_cast<uint64_t>(r) * stride + e % stride));
      s_two[e] = s | (match_of(w, s) ? kMatch : 0u);
    }
    __syncthreads();  // the tables are in
  }
  const C* cls = static_cast<const C*>(w.cls);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < w.n; i += step) {
    uint32_t st, word;
    int kk;
    begin(w, s_root, s_two, cls + i, st, word, kk);
    while (kk < w.depth && st != w.dead) {
      if ((kk & 31) == 0) {  // depths rise by one: plane by plane, in order
        w.planes[static_cast<int64_t>((kk >> 5) - 1) * w.n + i] = word;
        word = 0u;
      }
      const uint32_t c = static_cast<uint32_t>(__ldg(cls + i + kk));
      st = __ldg(w.trie + (static_cast<uint64_t>(st) * stride + c));
      word |= match_of(w, st) << (kk & 31);
      ++kk;
    }
    const int p = (kk - 1) >> 5;
    w.planes[static_cast<int64_t>(p) * w.n + i] = word;
    for (int q = p + 1; q < w.num_planes; ++q) w.planes[static_cast<int64_t>(q) * w.n + i] = 0u;
  }
}

// Checks the walk and its launch, sets the shared-memory limit, launches.
template <typename C>
int launch_typed(const Walk& w, unsigned grid, cudaStream_t stream) {
  const int64_t smem = smem_bytes(w);
  auto kernel = walk_kernel<C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

inline int launch(const Walk& w, int cls_bytes, unsigned grid, cudaStream_t stream) {
  if (w.n < 1 || w.stride < 1 || w.depth < 1 || w.num_planes < (w.depth + 31) / 32 ||
      w.states < 1 || w.states > static_cast<int64_t>(kState) + 1 || grid < 1u ||
      smem_bytes(w) > 232448)  // 227 KB: a block's on the H100
    return static_cast<int>(cudaErrorInvalidValue);
  if (cls_bytes == 1) return launch_typed<uint8_t>(w, grid, stream);
  if (cls_bytes == 2) return launch_typed<uint16_t>(w, grid, stream);
  if (cls_bytes == 4) return launch_typed<int32_t>(w, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pfac1
