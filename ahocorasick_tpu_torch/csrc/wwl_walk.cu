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
// What it computes.  The walk from start w follows the pure trie (no fail
// links): s = trie_next[s * A + cls[w + k]] for k = 0..max_depth, and dies at
// the first step that reaches dead = S - 1 (the JAX package's padded tables
// re-anchor the dead state there).  The pre-die state and the wordness of the
// die char (class_is_word[cls[w + k_die]]) decide the outcome, by the rules
// of WholeWordLongestMatchSet.java:65-94: a non-word die char emits the own
// match if any, else the carried fail match; a word die char emits only the
// fail match.  A walk that lives through all max_depth + 1 steps has k_die =
// -1 and the root's outcome at w - 1.  Class reads outside cls are the pad
// class 0.  Classes are uint8, uint16 or int32.
//
// Two tables derived from the trie (ops/scan_wwl.build_walk_tables, cached a
// matcher on the card): the k-gram prefix table, uint32[A^k] (k <= 3, k <=
// max_depth + 1), whose entry for classes c_0..c_{k-1} is the state after
// them, or, where the walk died at step j < k, kDied | j << kStateBits | the
// state before step j; and the outcome rows, int32[S, 8] (own_len, own_val,
// fail_len, fail_off, fail_val, three zeros): one 32-byte row a state.
//
// What bounds it on the H100.  A walk is a chain of up to d + 1 dependent
// loads from a table in L2 (10k keywords: 65,536 x 32 x 4 B = 8 MB), and its
// outcome is a gather at the pre-die state; the bytes it must move are the
// starts, the classes and 17 B of outcomes a start (0.043 ms at the 10k
// cell's 5,242,880 start slots).  Word starts in word soup walk few steps
// (the 10k cell: 3.2 trie loads a walk, 71% of walks dead within 3 chars;
// chip_smoke.py's "wwl walk loads" line), so what the card needs is many
// short chains in flight, not long ones kept busy.
//
// The design: one thread a start in 256-thread blocks, as many as the
// starts (bench/scan_variants.cu wwl_walk_first was the same), with
//   * one k-gram prefix lookup in place of the first k trie loads: the k
//     classes load together, then one load of the prefix table through the
//     read-only path (128 KB for the 10k dictionary's A = 32, k = 3), which
//     either ends the walk (with its pre-die state) or gives the state after
//     k chars;
//   * past the prefix, the next class loaded a step ahead of the trie load
//     that needs it, so each step waits on one load, not two;
//   * one outcome row a state (a 16-byte and a 4-byte load) in place of the
//     first design's five arrays read in two dependent rounds.
// On the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md) it took 0.100 ms at
// the 10k cell against the first design's 0.162 ms; k = 1, 2 or 3 took the
// same within 2%.  Designs that lost their A/B: the PFAC v2 walk's shape
// (csrc/pfac_walk.cuh: persistent blocks of 1,024 threads, each warp a span
// of starts, a prefix pass over classes staged in shared memory and the
// prefix table staged there, a warp queue of the walks that go on with lanes
// that refill) took 0.288 ms with the table in shared memory and 0.257 ms
// with it read with __ldg: with most walks dead within the prefix, each
// pass's chain of starts, stage, prefix and outcome loads was latency that
// its 32 warps an SM could not hide; and the prefix table staged in each
// block's shared memory (k = 2, 4 KB) took 0.108 ms.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 3;        // kernels/scan_wwl.WALK_MAX_K
constexpr int kStateBits = 28;  // kernels/scan_wwl.WALK_STATE_BITS
constexpr uint32_t kStateMask = (1u << kStateBits) - 1u;
constexpr uint32_t kDied = 1u << 31;  // kernels/scan_wwl.WALK_DIED

struct Walk {
  const int32_t* trie;     // int32[S, stride], dead = S - 1
  const uint32_t* prefix;  // uint32[stride^k]
  const int32_t* rows;     // int32[S, 8] outcome rows
  const uint8_t* word;     // class_is_word, bool[stride] read as bytes
  const void* cls;
  const int32_t* starts;
  int32_t* die_pos;
  bool* has;
  int32_t* m_start;
  int32_t* m_end;
  int32_t* m_val;
  int64_t num_cls, n;
  int stride, dead, max_depth, k;
};

template <typename C>
__device__ __forceinline__ uint32_t class_at(const C* __restrict__ cls, int64_t n, int64_t j) {
  return (j >= 0 && j < n) ? static_cast<uint32_t>(__ldg(cls + j)) : 0u;
}

// A thread a start: the k classes and one prefix lookup; the trie steps past
// the prefix, the next class loaded a step ahead; the outcome from the
// pre-die state's row and the die char's wordness.
template <typename C>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Walk a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int32_t w = __ldg(a.starts + i);
  const C* cls = static_cast<const C*>(a.cls);
  uint32_t c[kMaxK];
  uint32_t gram = 0u;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    c[j] = j < a.k ? class_at(cls, a.num_cls, int64_t{w} + j) : 0u;
    if (j < a.k) gram = gram * static_cast<uint32_t>(a.stride) + c[j];
  }
  const uint32_t e = __ldg(a.prefix + gram);
  int32_t kd = -1;  // -1: the walk lived through every step
  uint32_t s_last = 0u, die_class = 0u;
  if (e & kDied) {
    kd = static_cast<int32_t>((e >> kStateBits) & 3u);
    s_last = e & kStateMask;
    die_class = kd == 0 ? c[0] : kd == 1 ? c[1] : c[2];
  } else {
    uint32_t st = e;
    uint32_t next = a.k <= a.max_depth ? class_at(cls, a.num_cls, int64_t{w} + a.k) : 0u;
    for (int kk = a.k; kk <= a.max_depth; ++kk) {
      const uint32_t cc = next;
      if (kk < a.max_depth) next = class_at(cls, a.num_cls, int64_t{w} + kk + 1);
      const int32_t nxt =
          __ldg(a.trie + (static_cast<uint64_t>(st) * static_cast<uint32_t>(a.stride) + cc));
      if (nxt == a.dead) {
        kd = kk;
        s_last = st;
        die_class = cc;
        break;
      }
      st = static_cast<uint32_t>(nxt);
    }
    if (kd < 0) die_class = class_at(cls, a.num_cls, int64_t{w} - 1);
  }
  const int32_t* o = a.rows + static_cast<int64_t>(s_last) * 8;  // a 32-byte row
  const int4 q = __ldg(reinterpret_cast<const int4*>(o));
  const int32_t own = q.x, own_v = q.y, fail_l = q.z, fail_o = q.w, fail_v = __ldg(o + 4);
  const bool die_word = __ldg(a.word + die_class) != 0;
  const int32_t dp = w + kd;
  const bool has_own = own > 0 && !die_word;
  const bool has_fail = fail_l > 0 && (die_word || own == 0);
  const int32_t end = has_own ? dp : dp - fail_o;
  a.die_pos[i] = dp;
  a.has[i] = has_own || has_fail;
  a.m_start[i] = end - (has_own ? own : fail_l);
  a.m_end[i] = end;
  a.m_val[i] = has_own ? own_v : fail_v;
}

}  // namespace

// Tables as the JAX package pads them: trie_next int32[num_states, stride]
// (dead = num_states - 1), class_is_word bool[stride]; the derived prefix
// table uint32[stride^prefix_k] (prefix_k <= 3 and <= max_depth + 1) and
// outcome rows int32[num_states, 8] (16-byte aligned).  cls_bytes selects
// the uint8 (1), uint16 (2) or int32 (4) class instantiation.  The caller
// launches only non-empty work.  Returns cudaGetLastError() after the
// launch.
extern "C" int wwl_walks_at(const void* trie_next, const void* prefix, const void* rows,
                            const void* class_is_word, int num_states, int stride, int prefix_k,
                            const void* cls, int cls_bytes, int64_t num_cls, const void* starts,
                            int64_t num_starts, int max_depth, void* die_pos, void* has,
                            void* m_start, void* m_end, void* m_val, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t entries = 1;
  for (int j = 0; j < prefix_k && entries <= (int64_t{1} << 30); ++j) entries *= stride;
  if (num_starts < 1 || num_states < 1 || num_states > (1 << kStateBits) || stride < 1 ||
      max_depth < 0 || prefix_k < 1 || prefix_k > kMaxK || prefix_k > max_depth + 1 ||
      entries > (int64_t{1} << 30) || (reinterpret_cast<uintptr_t>(rows) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk a{};
  a.trie = static_cast<const int32_t*>(trie_next);
  a.prefix = static_cast<const uint32_t*>(prefix);
  a.rows = static_cast<const int32_t*>(rows);
  a.word = static_cast<const uint8_t*>(class_is_word);
  a.cls = cls;
  a.starts = static_cast<const int32_t*>(starts);
  a.die_pos = static_cast<int32_t*>(die_pos);
  a.has = static_cast<bool*>(has);
  a.m_start = static_cast<int32_t*>(m_start);
  a.m_end = static_cast<int32_t*>(m_end);
  a.m_val = static_cast<int32_t*>(m_val);
  a.num_cls = num_cls;
  a.n = num_starts;
  a.stride = stride;
  a.dead = num_states - 1;
  a.max_depth = max_depth;
  a.k = prefix_k;
  const auto grid = static_cast<unsigned>((num_starts + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  if (cls_bytes == 1) {
    walk_kernel<uint8_t><<<grid, kThreads, 0, st>>>(a);
  } else if (cls_bytes == 2) {
    walk_kernel<uint16_t><<<grid, kThreads, 0, st>>>(a);
  } else if (cls_bytes == 4) {
    walk_kernel<int32_t><<<grid, kThreads, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
