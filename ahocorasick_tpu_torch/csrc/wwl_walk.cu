// Per-start trie walk of the whole-word-longest matcher for Hopper (sm_90a),
// behind a plain C interface loaded with ctypes (ahocorasick_tpu_torch/
// kernels/build.py builds it, kernels/scan_wwl.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_wwl.py wwl_walks_at (jit at
// :137-178) and wwl_walks (:77-118, the same walk from every position), with
// _walk_outcomes (:121-134): a lax.fori_loop of d+1 steps, each one gather
// of the classes and one of trie_next over all lanes.  It is the engine for
// dictionaries that neither packed scan table of wwl_scan.cu can hold.
//
// What it computes.  Thread i walks the pure trie (no fail links) from start
// w = starts[i]: s = trie_next[s * A_pad + cls[w + k]] for k = 0..max_depth,
// and the walk dies at the first step that reaches dead = S_pad - 1 (the
// JAX package's padded tables re-anchor the dead state there).  The pre-die
// state and the wordness of the die char (class_is_word[cls[w + k_die]])
// decide the outcome, by the rules of WholeWordLongestMatchSet.java:65-94:
// a non-word die char emits the own match if any, else the carried fail
// match; a word die char emits only the fail match.  Class reads outside
// cls are the pad class 0.  Classes are uint8, uint16 or int32.
//
// What bounds it on the H100.  Each step is two loads, the class and then a
// trie_next entry whose address depends on the state the step before
// produced, so a walk is a chain of up to d+1 dependent loads from a table
// that sits in L2 (10k keywords: 65,536 x 32 x 4 B = 8 MB); starts are word
// starts, a few chars apart, so neighbouring threads read neighbouring
// classes.  What the design does about it: the state lives in a register,
// tables are read through the read-only path (__ldg), the walk stops at the
// step it dies (most walks die within a few chars), and the class loads do
// not depend on the chain, so they can be in flight ahead of it.  Staging
// the shallow trie levels in shared memory is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ int64_t class_at(const T* __restrict__ cls, int64_t n, int64_t j) {
  return (j >= 0 && j < n) ? static_cast<int64_t>(__ldg(cls + j)) : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    walks_kernel(const int32_t* __restrict__ trie_next, const int32_t* __restrict__ own_len,
                 const int32_t* __restrict__ own_val, const int32_t* __restrict__ fail_len,
                 const int32_t* __restrict__ fail_off, const int32_t* __restrict__ fail_val,
                 const bool* __restrict__ class_is_word, int32_t dead, int64_t stride,
                 const T* __restrict__ cls, int64_t num_cls, const int32_t* __restrict__ starts,
                 int64_t num_starts, int max_depth, int32_t* __restrict__ die_pos,
                 bool* __restrict__ has, int32_t* __restrict__ m_start,
                 int32_t* __restrict__ m_end, int32_t* __restrict__ m_val) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  const int32_t w = starts[i];
  int32_t s = 0, s_last = 0, kd = -1;
  for (int k = 0; k <= max_depth; ++k) {
    const int32_t nxt = __ldg(trie_next + (s * stride + class_at(cls, num_cls, int64_t{w} + k)));
    if (nxt == dead) {
      kd = k;
      s_last = s;
      break;
    }
    s = nxt;
  }
  const int32_t dp = w + kd;
  const bool die_word = class_is_word[class_at(cls, num_cls, dp)];
  const int32_t own = __ldg(own_len + s_last), fail_l = __ldg(fail_len + s_last);
  const bool has_own = own > 0 && !die_word;
  const bool has_fail = fail_l > 0 && (die_word || own == 0);
  const int32_t end = has_own ? dp : dp - __ldg(fail_off + s_last);
  die_pos[i] = dp;
  has[i] = has_own || has_fail;
  m_start[i] = end - (has_own ? own : fail_l);
  m_end[i] = end;
  m_val[i] = has_own ? __ldg(own_val + s_last) : __ldg(fail_val + s_last);
}

}  // namespace

// Tables as the JAX package pads them: trie_next int32[num_states, stride]
// (dead = num_states - 1), the five outcome arrays int32[num_states],
// class_is_word bool[stride].  cls_bytes selects the uint8 (1), uint16 (2) or
// int32 (4) class instantiation.  The caller launches only non-empty work.
// Returns cudaGetLastError() after the launch.
extern "C" int wwl_walks_at(const void* trie_next, const void* own_len, const void* own_val,
                            const void* fail_len, const void* fail_off, const void* fail_val,
                            const void* class_is_word, int num_states, int stride,
                            const void* cls, int cls_bytes, int64_t num_cls, const void* starts,
                            int64_t num_starts, int max_depth, void* die_pos, void* has,
                            void* m_start, void* m_end, void* m_val, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_starts < 1 || num_states < 1 || stride < 1 || max_depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((num_starts + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
#define WWL_WALKS_LAUNCH(T)                                                                     \
  walks_kernel<T><<<grid, kThreads, 0, st>>>(                                                   \
      static_cast<const int32_t*>(trie_next), static_cast<const int32_t*>(own_len),             \
      static_cast<const int32_t*>(own_val), static_cast<const int32_t*>(fail_len),              \
      static_cast<const int32_t*>(fail_off), static_cast<const int32_t*>(fail_val),             \
      static_cast<const bool*>(class_is_word), num_states - 1, stride,                          \
      static_cast<const T*>(cls), num_cls, static_cast<const int32_t*>(starts), num_starts,    \
      max_depth, static_cast<int32_t*>(die_pos), static_cast<bool*>(has),                       \
      static_cast<int32_t*>(m_start), static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val))
  if (cls_bytes == 1) {
    WWL_WALKS_LAUNCH(uint8_t);
  } else if (cls_bytes == 2) {
    WWL_WALKS_LAUNCH(uint16_t);
  } else if (cls_bytes == 4) {
    WWL_WALKS_LAUNCH(int32_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WWL_WALKS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
