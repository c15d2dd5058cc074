// Whole-word-longest scan engine for Hopper (sm_90a): the packed DFA scan
// plane and the die sweep with walk outcomes at the requested starts or at
// every position, behind
// a plain C interface loaded with ctypes (ahocorasick_tpu_torch/kernels/
// build.py builds it, kernels/scan_wwl.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_wwl.py wwl_scan_walks (jit at
// :685-744) with _wwl_core (:747-825) and _wwl_outcomes (:1027-1041): an XLA
// lax.scan that writes the packed entry of every position, a sweep over d+1
// shifted slices of that plane for every position, a compaction to the walk
// starts (the v5e row-gather trick _plane_take, not carried over) and the
// outcome-row gather.  And wwl_scan_walks_all (:1117-1155), the same core
// with the outcome-row gather at every position 0 .. n_keep-1, which the
// sharded scanner runs per shard: wwl_sweep_all.
//
// What it computes.  Table entries pack
//     id | depth << id_bits | word << (id_bits + depth_bits)
//        [| cross << (id_bits + depth_bits + 1)]
// (the next state or quotient row id, its trie depth, the wordness of the
// char's class, and for truncated closures whether the char leaves the
// word-uniform sub-trie).  wwl_scan_plane: thread b scans window b from the
// root, warms up over the `halo` left-context classes keeping v & idmask, and
// stores each body entry at flat text position b*C + j; for quotient tables
// it also stores the flat entry index s*A + c (A = num_classes), which
// rows_flat maps to the concrete trie state.  wwl_sweep_at: thread i takes
// start w = starts[i], finds k_die = min{k : depth(plane[w+k]) <= k} over
// k = 0..d, reads the die char's word and crossing bits (k = 0 never
// crosses), takes the pre-die state (plane[w+k_die-1] & idmask, or
// rows_flat[entry[w+k_die-1]]; the root when k_die = 0), and applies the
// outcome rules of WholeWordLongestMatchSet.java:65-94 to its outrows row.
// A start outside [0, L), L = B*C - (d+1), reads a zero sweep word, as the
// JAX engine's zero-padded plane gives padded start slots.  wwl_sweep_all:
// thread i is the walk from position i (no starts array: it would be an
// arange of 4*n_keep bytes read for nothing); n_keep <= L.
//
// What bounds it on the H100.  The plane kernel is the packed-scan kernel's
// chain: one table load per char whose address depends on the previous one,
// from a table that lives in the 50 MB L2 (10k keywords: 50,352 x 32 x 4 B
// = 6.4 MB), so each step is an L2 round trip and throughput comes only from
// windows in flight; its stores (4 B per char, 8 B for quotient tables) are
// per-thread strided.  The sweep issues up to d+1 plane reads per start,
// each one waiting on the test of the one before, then one or two dependent
// loads (rows_flat, the outrows row).  Starts are word starts a few chars
// apart, so a warp's reads fall in a few cache lines of the plane.  What the
// design does about it: the state and the sweep live in registers, tables
// are read through the read-only path (__ldg), flat indices are 64-bit, the
// sweep stops at the die step, and the plane is written once and read back
// only at the starts.  The every-position sweep is bound by bytes: it reads
// the plane once (neighbouring threads read neighbouring words, and the d+1
// words of a walk overlap its neighbours', so they come from L1) and writes
// four int32 and one or two bool planes.  Fusing the sweep into the scan,
// staging the table in shared memory and coalescing the window loads are
// later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    plane_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, uint32_t stride,
                 uint32_t num_classes, uint32_t idmask, uint32_t* __restrict__ plane,
                 int32_t* __restrict__ entry) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= num_windows) return;
  const T* row = windows + b * width;
  uint32_t s = 0;  // the root (compiler invariant: root row 0)
  for (int t = 0; t < halo; ++t) {
    const uint32_t c = static_cast<uint32_t>(row[t]);
    s = __ldg(table + (static_cast<uint64_t>(s) * stride + c)) & idmask;
  }
  const int64_t base = b * (width - halo) - halo;
  for (int t = halo; t < width; ++t) {
    const uint32_t c = static_cast<uint32_t>(row[t]);
    const uint32_t v = __ldg(table + (static_cast<uint64_t>(s) * stride + c));
    plane[base + t] = v;
    if (entry != nullptr) entry[base + t] = static_cast<int32_t>(s * num_classes + c);
    s = v & idmask;
  }
}

// One walk: the die sweep from start `w`, the pre-die state and the outcome
// rules, written to slot `i` of the outputs.
__device__ __forceinline__ void sweep_one(
    const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
    const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows, int64_t i,
    int32_t w, int64_t live, int d, int id_bits, int depth_bits, int cross,
    int32_t* __restrict__ die_pos, bool* __restrict__ has, int32_t* __restrict__ m_start,
    int32_t* __restrict__ m_end, int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  const uint32_t idmask = (1u << id_bits) - 1u;
  const uint32_t dmask = (1u << depth_bits) - 1u;
  int32_t kd = 0;
  bool die_word = false, crossed = false;
  int32_t s_last = 0;
  if (w >= 0 && w < live) {
    kd = -1;
    for (int k = 0; k <= d; ++k) {
      const uint32_t v = __ldg(plane + (static_cast<int64_t>(w) + k));
      if (((v >> id_bits) & dmask) <= static_cast<uint32_t>(k)) {
        kd = k;
        die_word = (v >> (id_bits + depth_bits)) & 1u;
        crossed = cross && k > 0 && ((v >> (id_bits + depth_bits + 1)) & 1u);
        break;
      }
    }
    if (kd > 0) {
      const int64_t p = static_cast<int64_t>(w) + kd - 1;
      s_last = entry != nullptr ? __ldg(rows_flat + __ldg(entry + p))
                                : static_cast<int32_t>(__ldg(plane + p) & idmask);
    }
  }
  const int32_t* o = outrows + static_cast<int64_t>(s_last) * 8;
  const int32_t own = __ldg(o), own_v = __ldg(o + 1);
  const int32_t fail_l = __ldg(o + 2), fail_o = __ldg(o + 3), fail_v = __ldg(o + 4);
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

__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                 const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows,
                 const int32_t* __restrict__ starts, int64_t num_starts, int64_t live, int d,
                 int id_bits, int depth_bits, int cross, int32_t* __restrict__ die_pos,
                 bool* __restrict__ has, int32_t* __restrict__ m_start,
                 int32_t* __restrict__ m_end, int32_t* __restrict__ m_val,
                 bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  sweep_one(plane, entry, rows_flat, outrows, i, starts[i], live, d, id_bits, depth_bits, cross,
            die_pos, has, m_start, m_end, m_val, cont);
}

// The sweep at every position 0 .. n_keep-1: a thread's start is its own
// index, so no starts array is read.
__global__ void __launch_bounds__(kThreads)
    sweep_all_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ entry,
                     const int32_t* __restrict__ rows_flat, const int32_t* __restrict__ outrows,
                     int64_t n_keep, int64_t live, int d, int id_bits, int depth_bits, int cross,
                     int32_t* __restrict__ die_pos, bool* __restrict__ has,
                     int32_t* __restrict__ m_start, int32_t* __restrict__ m_end,
                     int32_t* __restrict__ m_val, bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_keep) return;
  sweep_one(plane, entry, rows_flat, outrows, i, static_cast<int32_t>(i), live, d, id_bits,
            depth_bits, cross, die_pos, has, m_start, m_end, m_val, cont);
}

unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// The entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types and launches
// only non-empty work.  class_bytes selects the uint8 (1), uint16 (2) or
// int32 (4) window instantiation; `stride` is the table's row length (the
// padded class count for the row layout, num_classes for the flat one).
// `entry` is null for dense tables; `plane` is uint32[num_windows * (width -
// halo)].
extern "C" int wwl_scan_plane(const void* table, const void* windows, int class_bytes,
                              int64_t num_windows, int width, int halo, int stride,
                              int num_classes, int id_bits, void* plane, void* entry,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_windows < 1 || id_bits < 1 || id_bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* out = static_cast<uint32_t*>(plane);
  auto* ent = static_cast<int32_t*>(entry);
  const uint32_t idmask = (1u << id_bits) - 1u;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows);
  const auto s = static_cast<uint32_t>(stride);
  const auto a = static_cast<uint32_t>(num_classes);
  if (class_bytes == 1) {
    plane_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, s, a, idmask, out, ent);
  } else if (class_bytes == 2) {
    plane_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, s, a, idmask, out, ent);
  } else if (class_bytes == 4) {
    plane_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const int32_t*>(windows), num_windows, width, halo, s, a, idmask, out, ent);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `live` = L, the plane positions a start may begin at.  `entry` and
// `rows_flat` are null for dense tables; `cont` is null unless `cross`.
extern "C" int wwl_sweep_at(const void* plane, const void* entry, const void* rows_flat,
                            const void* outrows, const void* starts, int64_t num_starts,
                            int64_t live, int d, int id_bits, int depth_bits, int cross,
                            void* die_pos, void* has, void* m_start, void* m_end, void* m_val,
                            void* cont, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_starts < 1 || d < 0 || (entry == nullptr) != (rows_flat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  sweep_kernel<<<grid_for(num_starts), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(plane), static_cast<const int32_t*>(entry),
      static_cast<const int32_t*>(rows_flat), static_cast<const int32_t*>(outrows),
      static_cast<const int32_t*>(starts), num_starts, live, d, id_bits, depth_bits, cross,
      static_cast<int32_t*>(die_pos), static_cast<bool*>(has), static_cast<int32_t*>(m_start),
      static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val), static_cast<bool*>(cont));
  return static_cast<int>(cudaGetLastError());
}

// The sweep at every position 0 .. n_keep-1 of the plane (n_keep <= live, so
// every start reads d+1 real plane words); outputs have n_keep slots.
extern "C" int wwl_sweep_all(const void* plane, const void* entry, const void* rows_flat,
                             const void* outrows, int64_t n_keep, int64_t live, int d,
                             int id_bits, int depth_bits, int cross, void* die_pos, void* has,
                             void* m_start, void* m_end, void* m_val, void* cont, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_keep < 1 || n_keep > live || live > 2147483647 || d < 0 ||
      (entry == nullptr) != (rows_flat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  sweep_all_kernel<<<grid_for(n_keep), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(plane), static_cast<const int32_t*>(entry),
      static_cast<const int32_t*>(rows_flat), static_cast<const int32_t*>(outrows), n_keep, live,
      d, id_bits, depth_bits, cross, static_cast<int32_t*>(die_pos), static_cast<bool*>(has),
      static_cast<int32_t*>(m_start), static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val),
      static_cast<bool*>(cont));
  return static_cast<int>(cudaGetLastError());
}
