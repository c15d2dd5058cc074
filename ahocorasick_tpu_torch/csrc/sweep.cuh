// The whole-word-longest die sweep for Hopper (sm_90a): the outcome rules and
// the walk of wwl_scan.cu's wwl_sweep_at and wwl_sweep_all, with a walk's
// plane words loaded in groups, kept in a header so that
// bench/scan_variants.cu can time other groups, and a warp's span of the
// plane staged in shared memory, beside the package's choice (wwl_scan.cu
// kSweepGroup).
//
// What a walk computes.  A walk from start w reads the plane words
// plane[w + k], k = 0..d, and dies at k_die = min{k : depth(plane[w+k]) <=
// k} (k_die = -1 if none does: a plane that is not the scan of a table of
// depth <= d); it takes the die word's wordness and crossing bits (k = 0
// never crosses) and the pre-die word plane[w + k_die - 1] (k_die > 0).
// Every address is known from w, and all d+1 are in bounds for w < live =
// N - (d+1).
//
// What the design does.  The first design loaded plane[w + k] only after
// the test on plane[w + k - 1] had failed, a chain of up to d+1 L1/L2 round
// trips a walk, and read the pre-die word a second time.  Here a walk loads
// G words at once, plane[w + g0 .. w + g0 + G), every load of the group
// issued before any test, finds the first death of the group in registers
// (a bit mask and __ffs), and loads the next group only if no word of the
// group died; the pre-die word is the word before the die word in the group,
// or the last word of the group before, so it is never read again.  Starts
// that are unsorted, repeated, negative or at or past live need no order:
// each slot walks on its own.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sweep {

// The outcome rules over the pre-die state's outrows row (16-byte aligned:
// the wrappers check), written to slot `i` of the outputs: a walk from `w`
// that died k_die chars later.
__device__ __forceinline__ void write_outcome(
    const int32_t* __restrict__ outrows, int64_t i, int32_t w, int32_t kd, bool die_word,
    bool crossed, int32_t s_last, int32_t* __restrict__ die_pos, bool* __restrict__ has,
    int32_t* __restrict__ m_start, int32_t* __restrict__ m_end, int32_t* __restrict__ m_val,
    bool* __restrict__ cont) {
  const int32_t* o = outrows + static_cast<int64_t>(s_last) * 8;  // a 32-byte row
  const int4 q = __ldg(reinterpret_cast<const int4*>(o));
  const int32_t own = q.x, own_v = q.y, fail_l = q.z, fail_o = q.w, fail_v = __ldg(o + 4);
  const int32_t dp = w + kd;
  const bool has_own = own > 0 && !die_word;
  const bool has_fail = fail_l > 0 && (die_word || own == 0);
  const int32_t end = has_own ? dp : dp - fail_o;
  die_pos[i] = dp;
  has[i] = has_own || has_fail;
  m_start[i] = end - (has_own ? own : fail_l);
  m_end[i] = end;
  m_val[i] = has_own ? own_v : fail_v;
  if (cont != nullptr) cont[i] = crossed;
}

// A walk's die: k_die (-1 if no word died), the die word's wordness and
// crossing bits, and the pre-die word (k_die > 0).
struct Die {
  int32_t kd;
  bool word;
  bool crossed;
  uint32_t pre;
};

// The walk over words[0..d] (the plane, or a staged copy of it: `global`
// says which): groups of G loads, each group's loads issued before its
// tests.
template <int G>
__device__ __forceinline__ Die die_of(const uint32_t* words, bool global, int d, int id_bits,
                                      int depth_bits, int cross) {
  const uint32_t dmask = (1u << depth_bits) - 1u;
  uint32_t last = 0u;  // the last word of the group before
  for (int g0 = 0; g0 <= d; g0 += G) {
    uint32_t v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      v[j] = g0 + j > d ? 0u : global ? __ldg(words + g0 + j) : words[g0 + j];
    }
    unsigned hit = 0u;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool dies =
          g0 + j <= d && ((v[j] >> id_bits) & dmask) <= static_cast<uint32_t>(g0 + j);
      hit |= static_cast<unsigned>(dies) << j;
    }
    if (hit != 0u) {
      const int j = __ffs(hit) - 1;
      uint32_t die = v[0], pre = last;
#pragma unroll
      for (int jj = 1; jj < G; ++jj) {
        if (jj == j) {
          die = v[jj];
          pre = v[jj - 1];
        }
      }
      const int32_t kd = g0 + j;
      return {kd, ((die >> (id_bits + depth_bits)) & 1u) != 0u,
              cross && kd > 0 && ((die >> (id_bits + depth_bits + 1)) & 1u) != 0u, pre};
    }
    last = v[G - 1];
  }
  return {-1, false, false, 0u};
}

// One slot: the walk from `w` (a walk only where 0 <= w < live; other slots
// read the zero sweep word: k_die 0 from the root) given its die `r`, the
// pre-die state and the outcome rules, written to slot `i`.
__device__ __forceinline__ void finish_slot(
    const int32_t* __restrict__ entry, const int32_t* __restrict__ rows_flat,
    const int32_t* __restrict__ outrows, int64_t i, int32_t w, const Die& r, int id_bits,
    int32_t* __restrict__ die_pos, bool* __restrict__ has, int32_t* __restrict__ m_start,
    int32_t* __restrict__ m_end, int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  int32_t s_last = 0;
  if (r.kd > 0) {
    s_last = entry != nullptr
                 ? __ldg(rows_flat + __ldg(entry + (static_cast<int64_t>(w) + r.kd - 1)))
                 : static_cast<int32_t>(r.pre & ((1u << id_bits) - 1u));
  }
  write_outcome(outrows, i, w, r.kd, r.word, r.crossed, s_last, die_pos, has, m_start, m_end,
                m_val, cont);
}

// The sweep at `starts`: thread i takes slot i.
template <int G>
__global__ void __launch_bounds__(256)
    sweep_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                 const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows,
                 const int32_t* __restrict__ starts, int64_t num_starts, int64_t live, int d,
                 int id_bits, int depth_bits, int cross, int32_t* __restrict__ die_pos,
                 bool* __restrict__ has, int32_t* __restrict__ m_start,
                 int32_t* __restrict__ m_end, int32_t* __restrict__ m_val,
                 bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_starts) return;
  const int32_t w = __ldg(starts + i);
  const Die r = w >= 0 && w < live ? die_of<G>(plane + w, true, d, id_bits, depth_bits, cross)
                                   : Die{0, false, false, 0u};
  finish_slot(entry, rows_flat, outrows, i, w, r, id_bits, die_pos, has, m_start, m_end, m_val,
              cont);
}

// The sweep at every position 0 .. n_keep-1: a thread's start is its own
// index, so no starts array is read.
template <int G>
__global__ void __launch_bounds__(256)
    sweep_all_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                     const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows,
                     int64_t n_keep, int64_t live, int d, int id_bits, int depth_bits, int cross,
                     int32_t* __restrict__ die_pos, bool* __restrict__ has,
                     int32_t* __restrict__ m_start, int32_t* __restrict__ m_end,
                     int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_keep) return;  // n_keep <= live: every slot walks
  const auto w = static_cast<int32_t>(i);
  finish_slot(entry, rows_flat, outrows, i, w,
              die_of<G>(plane + w, true, d, id_bits, depth_bits, cross), id_bits, die_pos, has,
              m_start, m_end, m_val, cont);
}

}  // namespace sweep
