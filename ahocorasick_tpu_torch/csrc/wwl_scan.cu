// Whole-word-longest scan engine for Hopper (sm_90a): the packed DFA scan
// plane, the die sweep with walk outcomes at the requested starts or at
// every position, and the fused scan that finds every walk's die position
// inside the scan and writes no plane, behind a plain C interface loaded
// with ctypes (ahocorasick_tpu_torch/kernels/build.py builds it,
// kernels/scan_wwl.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_wwl.py wwl_scan_walks (jit at
// :685-744) with _wwl_core (:747-825) and _wwl_outcomes (:1027-1041): an XLA
// lax.scan that writes the packed entry of every position, a sweep over d+1
// shifted slices of that plane for every position, a compaction to the walk
// starts (the v5e row-gather trick _plane_take, not carried over) and the
// outcome-row gather.  wwl_scan_walks_all (:1117-1155), the same core with
// the outcome-row gather at every position 0 .. n_keep-1, which the sharded
// scanner runs per shard: wwl_sweep_all.  And wwl_scan_walks_fused (:866,
// its lax.scan at :947): the die sweep carried through the scan in a ring
// of d+1 slots per lane, one packed record per walk, then the same take and
// outcome gather: wwl_scan_fused.
//
// What it computes.  Table entries pack
//     id | depth << id_bits | word << (id_bits + depth_bits)
//        [| cross << (id_bits + depth_bits + 1)]
// (the next state or quotient row id, its trie depth, the wordness of the
// char's class, and for truncated closures whether the char leaves the
// word-uniform sub-trie).  wwl_scan_plane: lane k of window b scans the
// segment [k*L, min((k+1)*L, C)) of the window's body, warmed from the root
// over the `halo` classes just before it, and stores each body entry at flat
// text position b*C + j; for quotient tables it also stores the flat entry
// index s*A + c (A = num_classes), which rows_flat maps to the concrete trie
// state.  The wrapper fixes K and L by the planes scan's one rule
// (kernels/scan_block.py segments; K = 1 where halo = 0), and the plain twin
// takes the same segments.  wwl_sweep_at: thread i takes start
// w = starts[i], finds k_die = min{k : depth(plane[w+k]) <= k} over k = 0..d,
// reads the die char's word and crossing bits (k = 0 never crosses), takes
// the pre-die state (plane[w+k_die-1] & idmask, or
// rows_flat[entry[w+k_die-1]]; the root when k_die = 0), and applies the
// outcome rules of WholeWordLongestMatchSet.java:65-94 to its outrows row.
// A start outside [0, L), L = B*C - (d+1), reads a zero sweep word, as the
// JAX engine's zero-padded plane gives padded start slots.  wwl_sweep_all:
// thread i is the walk from position i (no starts array: it would be an
// arange of 4*n_keep bytes read for nothing); n_keep <= L.
//
// The fused scan, and why it needs no ring.  Its windows are
// chunk_classes_overlap's: halo + C + d + 1 classes a row, so every walk
// that starts in the body ends in the row.  In these tables the target of
// an entry is never more than one deeper than its source,
// depth(delta(s, c)) <= depth(s) + 1: the scan state is the longest suffix
// of the text read that is a path of the (truncated) trie, and the longest
// such suffix after one more char, less that char, is a suffix of the text
// before it that is a path, so it is no longer than the state before.  So
// g(p) = p - depth(plane[p]) never decreases along the text, and the sweep's
// k_die(w) = min{k : depth(plane[w+k]) <= k} is the first p with g(p) >= w,
// minus w.  Starts are sorted (compact_lanes pads with len(cls)), so walks
// die in start order, and one forward cursor per lane replaces the JAX
// kernel's ring: at each position p with entry v, while
// p - depth(v) >= starts[j], walk j died at p, with k_die = p - starts[j],
// the word and crossing bits of v, and the pre-die state (the state before
// p; the root when k_die = 0).  That is no d+1 compare-and-select a char and
// no per-char record; a lane carries its state, its position and the next
// two starts in registers.  (tests/test_torch_wwl_fused.py asserts the depth
// property on every dense table those tests build, pure and mixed.  The
// JAX formulation, the ring, is the plain twin's, so the cursor is held
// against an independent algorithm.)  Lanes are the plane kernel's segments.
// A lane warms from the root over the `halo` classes before its segment
// while it binary-searches `starts` for its first slot and for the first
// slot past it (three chains of dependent loads in flight together; about
// 23 steps each at 5 Mi slots), scans its tiles of 16 chars as a chain of
// lookups with nothing between them, then finds the tile's deaths in a
// burst, and stops when its last start has died: it reads no class past
// the d classes after its segment.  It writes one record per distinct
// start, k_die | word << kd_bits [| cross << (kd_bits + 1)] | s_pre <<
// (kd_bits + nflag), the JAX record without its `died` bit;
// fused_applicable's bit budget is what lets it fit.  A second launch, a
// thread per start slot, gives each slot its outcome from that record and
// its outrows row, as the sweep does from the plane: a start outside [0, L)
// takes the sweep's zero word, and a start equal to the one before it takes
// the record of the first slot that holds that start (the padded slots are
// all equal, and one lane writing them all would serialize).
//
// What bounds it on the H100.  The plane kernel is the packed-scan kernel's
// chain: one table load per char whose address depends on the previous one,
// from a table that lives in the 50 MB L2 (10k keywords: 50,352 x 32 x 4 B
// = 6.4 MB), so each step is an L2 or L1 round trip and throughput comes
// only from lanes in flight.  Its stores (4 B per char, 8 B for quotient
// tables) were per-thread strided in its first form (0.769 ms at the 10k
// cell's 65,537 x 524 windows against a byte bound of 0.0503 ms): every
// store opened its own sector and every lane held its own window's L1 line.
// This design is the packed planes kernel's (packed_scan.cu): classes read
// a 32-bit word at a time, funnel-shifted over unaligned rows (tile.cuh),
// and a 16-step shared-memory store tile with an odd pitch, left with
// 16-byte stores where the runs are aligned and 4-byte full-sector runs
// where not; a quotient table's entry plane leaves through the same tile
// after the plane.  The sweeps (sweep.cuh) load a walk's plane words in
// groups of kSweepGroup, every load of a group issued before any test, and
// keep the pre-die word in registers, where the first design issued a load
// only after the test on the one before and read the pre-die word again;
// then one or two dependent loads (rows_flat for quotient tables, the
// outrows row).  What bounds them is bytes, not that chain: walks start at
// the words of the text and read through them, so together they read almost
// every 32-byte sector of the plane, which at the 10k cell (134 MB) lies
// past the 50 MB L2 and comes from device memory once, besides the starts
// and four int32 and one or two bool planes written: at the 10k cell its
// walks touch 4,128,321 of the plane's 4,194,368 sectors, 242 MB in all with
// the starts and the outcomes, 0.072 ms at 3.35 TB/s (chip_smoke.py's "sweep
// plane sectors" line).  The grouped loads took the every-position sweep of
// a 4 Mi shard (a 16.8 MB plane) from 0.0510 to 0.0413 ms and the sweep at
// the 10k cell's start slots from 0.0906 to 0.0876 ms, about 2.8 TB/s of
// those bytes; a warp's span staged in shared memory was slower
// (bench/scan_variants.cu).  The fused scan is the same chain as the plane
// kernel, with no plane: its bytes are the
// windows, the starts and the outcomes, at the 10k cell 65,537 x 537 B +
// 4 B x 5,242,880 + 17 B x 5,242,880, about 145 MB or 0.043 ms at 3.35 TB/s,
// against the plane-plus-sweep route's 0.088 ms.  Its record per start
// (4 B, written in slot order by each lane) and the second launch's reads
// of it are traffic above that bound; they keep the outrows loads and the
// 17 B of outcomes off the scan's chain.  What it costs instead of the
// plane's stores is the work of finding the deaths: a compare a char and,
// at about one char in six a lane, a record, a store and the next start's
// load, which a warp's lanes take at different chars, so the warp runs
// that path at almost every char.  On the card (probes/probe_wwl_fused.py,
// PERF.md) that work costs about what the plane's stores cost, and the
// resolve launch about what the sweep costs, so the fused route is no
// faster than the plane and the sweep; FUSED_DEFAULT says which runs.
// The state lives in a register, tables are read through the read-only path
// (__ldg), flat table indices are 64-bit.  Staging the table in shared
// memory is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "sweep.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
// The die sweep's loads a group (sweep.cuh), from the A/B of
// bench/scan_variants.py sweep_ab (chip_smoke.py's "ab sweep" line; NVIDIA
// H100 80GB HBM3, 700 W; the 10k cell, d = 12): at 5,242,880 start slots the
// first design took 0.0906 ms, G = 1, 2, 4, 8, 16 0.0904, 0.0890, 0.0876,
// 0.0902, 0.1021 ms, each 12-20% slower with a warp's span staged in shared
// memory; at every position of 4 Mi the first design 0.0510 ms, G = 1, 2, 4,
// 8, 16 0.0498, 0.0451, 0.0413, 0.0450, 0.0657 ms, staged 0.0502 at best.
constexpr int kSweepGroup = 4;

template <typename T, bool kEntry>
__global__ void __launch_bounds__(kThreads)
    plane_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, uint32_t stride,
                 uint32_t num_classes, uint32_t idmask, int segments, int seg_len, bool vec,
                 uint32_t* __restrict__ plane, uint32_t* __restrict__ entry) {
  using tile::kFull;
  using tile::kPitch;
  using tile::kTileSteps;
  __shared__ uint32_t tiles[kThreads * kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;  // window
  const int start = static_cast<int>(g - b * segments) * seg_len;  // first body position
  const int body = width - halo;
  const int len = b < num_windows ? min(seg_len, body - start) : 0;
  // The segment's warm-up classes are row[start, start + halo), its body
  // classes follow them.
  const T* seg = windows + b * width + start;
  uint32_t s = 0;  // the root (compiler invariant: root row 0)
  if (len > 0) {
    for (int t = 0; t < halo; ++t) {
      s = __ldg(table + (static_cast<uint64_t>(s) * stride + static_cast<uint32_t>(seg[t]))) &
          idmask;
    }
  }
  seg += halo;
  uint32_t* row = tiles + threadIdx.x * kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * kPitch;
  const long long dst = b * body + start;
  const int steps = __reduce_max_sync(kFull, len);
  for (int t0 = 0; t0 < steps; t0 += kTileSteps) {
    const int n = min(kTileSteps, len - t0);  // <= 0 once this lane is done
    tile::ClassWords<T> cls;
    cls.load(seg + t0, n);
    uint32_t ent[kTileSteps];
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        const uint32_t c = cls.at(t);
        const uint32_t v = __ldg(table + (static_cast<uint64_t>(s) * stride + c));
        row[t] = v;
        if (kEntry) ent[t] = s * num_classes + c;
        s = v & idmask;
      }
    }
    __syncwarp();
    tile::store_tile(warp_tile, lane, dst + t0, n, vec, plane);
    __syncwarp();  // the rows are rewritten next
    if (kEntry) {
#pragma unroll
      for (int t = 0; t < kTileSteps; ++t) {
        if (t < n) row[t] = ent[t];
      }
      __syncwarp();
      tile::store_tile(warp_tile, lane, dst + t0, n, vec, entry);
      __syncwarp();
    }
  }
}

using sweep::write_outcome;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// First index in [lo, hi) whose start is >= value (> value with `after`),
// or hi.
__device__ __forceinline__ int64_t search(const int32_t* __restrict__ starts, int64_t lo,
                                          int64_t hi, int64_t value, bool after) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    const int64_t s = __ldg(starts + mid);
    if (s < value || (after && s == value)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first slot past a run of equal starts: called only at a duplicate, so
// kept out of line (the scan's unrolled loop holds sixteen call sites).
__device__ __noinline__ int32_t past_equal(const int32_t* __restrict__ starts, int32_t lo,
                                           int32_t hi, int32_t value) {
  return static_cast<int32_t>(search(starts, lo, hi, value, true));
}

// The fused scan's lanes: each writes the record of every distinct start of
// its segment that lies in [0, live).  Positions and slots are 32-bit (the
// wrapper keeps B*C below 2**31).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const uint32_t* __restrict__ table, const T* __restrict__ windows,
                 int64_t num_windows, int width, int halo, int body, uint32_t stride, int d,
                 int id_bits, int depth_bits, int kd_bits, int cross, int segments,
                 int seg_len, const int32_t* __restrict__ starts, int64_t num_starts,
                 int64_t live, uint32_t* __restrict__ meta) {
  using tile::kTileSteps;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / segments;  // window
  if (b >= num_windows) return;
  const int col0 = static_cast<int>(g - b * segments) * seg_len;  // the segment's first column
  const int32_t base = static_cast<int32_t>(b * body);  // text position of body column 0
  const int32_t lo = base + col0;
  const int32_t hi = static_cast<int32_t>(
      min64(min64(static_cast<int64_t>(lo) + seg_len, static_cast<int64_t>(base) + body), live));
  if (lo >= hi) return;
  const uint32_t idmask = (1u << id_bits) - 1u;
  const uint32_t dmask = (1u << depth_bits) - 1u;
  const T* row = windows + b * width;
  // Three chains of dependent loads at once: the warm-up from the root over
  // the halo classes before the segment, and the binary searches for the
  // segment's first start slot and for the first slot past the segment.
  uint32_t s = 0;
  int32_t a0 = 0, a1 = static_cast<int32_t>(num_starts);
  int32_t e0 = 0, e1 = a1;
  for (int t = 0; t < halo || a0 < a1 || e0 < e1; ++t) {
    if (t < halo) {
      const uint32_t c = static_cast<uint32_t>(row[col0 + t]);
      s = __ldg(table + (static_cast<uint64_t>(s) * stride + c)) & idmask;
    }
    if (a0 < a1) {
      const int32_t mid = a0 + (a1 - a0) / 2;
      if (__ldg(starts + mid) < lo) a0 = mid + 1; else a1 = mid;
    }
    if (e0 < e1) {
      const int32_t mid = e0 + (e1 - e0) / 2;
      if (__ldg(starts + mid) < hi) e0 = mid + 1; else e1 = mid;
    }
  }
  int32_t j = a0;
  const int32_t jend = e0;
  if (j >= jend) return;
  const int nflag = cross ? 2 : 1;
  int32_t sj = __ldg(starts + j);  // the next walk to die, then the one after it
  const int32_t s_last = __ldg(starts + jend - 1);
  if (sj < lo || s_last < sj) return;  // unsorted starts (the wrapper raises): read nothing
  int32_t sn = j + 1 < jend ? __ldg(starts + j + 1) : INT32_MAX;
  // The last body column a walk of this lane may need (within the row).
  const int steps = min(s_last - base + d, width - halo - 1) - col0 + 1;
  const T* body_cls = row + halo + col0;
  int32_t p = lo;  // text position of the tile's first char
  for (int t0 = 0; t0 < steps && j < jend; t0 += kTileSteps) {
    const int n = min(kTileSteps, steps - t0);
    tile::ClassWords<T> cls;
    cls.load(body_cls + t0, n);
    // The tile's lookups, a chain of dependent loads with nothing between
    // them, then its deaths found in a burst.
    uint32_t v[kTileSteps];
    uint32_t sp = s;  // the state before char t
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        v[t] = __ldg(table + (static_cast<uint64_t>(s) * stride + cls.at(t)));
        s = v[t] & idmask;
      }
    }
#pragma unroll
    for (int t = 0; t < kTileSteps; ++t) {
      if (t < n) {
        const int32_t gp = p + t - static_cast<int32_t>((v[t] >> id_bits) & dmask);
        while (sj <= gp) {  // the walk from sj died at p + t
          const uint32_t kd = static_cast<uint32_t>(p + t - sj);
          uint32_t rec = kd | (((v[t] >> (id_bits + depth_bits)) & 1u) << kd_bits);
          if (kd > 0) {
            if (cross) rec |= ((v[t] >> (id_bits + depth_bits + 1)) & 1u) << (kd_bits + 1);
            rec |= sp << (kd_bits + nflag);
          }
          meta[j] = rec;
          int32_t nj = j + 1;
          if (sn == sj) {  // equal starts: the resolve launch copies this record
            nj = past_equal(starts, nj, jend, sj);
            sn = nj < jend ? __ldg(starts + nj) : INT32_MAX;
          }
          j = nj;
          sj = sn;
          sn = j + 1 < jend ? __ldg(starts + j + 1) : INT32_MAX;
        }
        sp = v[t] & idmask;
      }
    }
    p += n;
  }
}

// A thread per start slot: the outcome from the record of its start.
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(const int32_t* __restrict__ starts, const uint32_t* __restrict__ meta,
                   const int32_t* __restrict__ outrows, int64_t num_starts, int64_t live,
                   int id_bits, int kd_bits, int cross, int32_t* __restrict__ die_pos,
                   bool* __restrict__ has, int32_t* __restrict__ m_start,
                   int32_t* __restrict__ m_end, int32_t* __restrict__ m_val,
                   bool* __restrict__ cont) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_starts) return;
  const int32_t w = starts[i];
  int32_t kd = 0, s_last = 0;
  bool die_word = false, crossed = false;
  if (w >= 0 && w < live) {
    const int64_t src = i > 0 && starts[i - 1] == w ? search(starts, 0, i, w, false) : i;
    const uint32_t rec = meta[src];
    const int nflag = cross ? 2 : 1;
    kd = static_cast<int32_t>(rec & ((1u << kd_bits) - 1u));
    die_word = (rec >> kd_bits) & 1u;
    crossed = cross && ((rec >> (kd_bits + 1)) & 1u);
    s_last = static_cast<int32_t>((rec >> (kd_bits + nflag)) & ((1u << id_bits) - 1u));
  }
  write_outcome(outrows, i, w, kd, die_word, crossed, s_last, die_pos, has, m_start, m_end,
                m_val, cont);
}

unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

using tile::valid_segments;

template <typename T>
void launch_plane(const uint32_t* tab, const void* windows, int64_t num_windows, int width,
                  int halo, uint32_t stride, uint32_t a, uint32_t idmask, int segments,
                  int seg_len, bool vec, uint32_t* out, uint32_t* ent, cudaStream_t st) {
  const unsigned grid = grid_for(num_windows * segments);
  const T* w = static_cast<const T*>(windows);
  if (ent != nullptr) {
    plane_kernel<T, true><<<grid, kThreads, 0, st>>>(tab, w, num_windows, width, halo, stride, a,
                                                     idmask, segments, seg_len, vec, out, ent);
  } else {
    plane_kernel<T, false><<<grid, kThreads, 0, st>>>(tab, w, num_windows, width, halo, stride,
                                                      a, idmask, segments, seg_len, vec, out,
                                                      nullptr);
  }
}

}  // namespace

// The entry points return cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types and launches
// only non-empty work.  class_bytes selects the uint8 (1), uint16 (2) or
// int32 (4) window instantiation; `stride` is the table's row length (the
// padded class count for the row layout, num_classes for the flat one).
// `entry` is null for dense tables; `plane` is uint32[num_windows * (width -
// halo)].  `segments` and `seg_len` as valid_segments says.
extern "C" int wwl_scan_plane(const void* table, const void* windows, int class_bytes,
                              int64_t num_windows, int width, int halo, int stride,
                              int num_classes, int id_bits, int segments, int seg_len,
                              void* plane, void* entry, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int body = width - halo;
  if (num_windows < 1 || id_bits < 1 || id_bits > 30 ||
      !valid_segments(segments, seg_len, body, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* out = static_cast<uint32_t*>(plane);
  auto* ent = static_cast<uint32_t*>(entry);
  // Runs start at b*C + k*L + a multiple of 16: 16-byte aligned when C and
  // L are multiples of 4 and the planes are.
  const bool vec = tile::vec_runs(body, seg_len, out) && tile::vec_runs(body, seg_len, ent);
  const uint32_t idmask = (1u << id_bits) - 1u;
  auto st = static_cast<cudaStream_t>(stream);
  const auto s = static_cast<uint32_t>(stride);
  const auto a = static_cast<uint32_t>(num_classes);
  if (class_bytes == 1) {
    launch_plane<uint8_t>(tab, windows, num_windows, width, halo, s, a, idmask, segments, seg_len,
                          vec, out, ent, st);
  } else if (class_bytes == 2) {
    launch_plane<uint16_t>(tab, windows, num_windows, width, halo, s, a, idmask, segments,
                           seg_len, vec, out, ent, st);
  } else if (class_bytes == 4) {
    launch_plane<int32_t>(tab, windows, num_windows, width, halo, s, a, idmask, segments, seg_len,
                          vec, out, ent, st);
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
  sweep::sweep_kernel<kSweepGroup>
      <<<grid_for(num_starts), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  sweep::sweep_all_kernel<kSweepGroup>
      <<<grid_for(n_keep), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(plane), static_cast<const int32_t*>(entry),
      static_cast<const int32_t*>(rows_flat), static_cast<const int32_t*>(outrows), n_keep, live,
      d, id_bits, depth_bits, cross, static_cast<int32_t*>(die_pos), static_cast<bool*>(has),
      static_cast<int32_t*>(m_start), static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val),
      static_cast<bool*>(cont));
  return static_cast<int>(cudaGetLastError());
}

// The fused scan over chunk_classes_overlap windows (width = halo + C + d +
// 1) of a dense table, at sorted `starts`: two launches on `stream`, the
// lanes (records into `meta`, uint32[num_starts] scratch) and the outcomes.
// `cont` is null unless `cross`.
extern "C" int wwl_scan_fused(const void* table, const void* windows, int class_bytes,
                              int64_t num_windows, int width, int halo, int stride, int d,
                              int id_bits, int depth_bits, int cross, int segments, int seg_len,
                              const void* starts, int64_t num_starts, const void* outrows,
                              void* meta, void* die_pos, void* has, void* m_start, void* m_end,
                              void* m_val, void* cont, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kd_bits = 1;
  while ((1 << kd_bits) <= d) ++kd_bits;
  const int body = width - halo - (d + 1);
  if (num_windows < 1 || num_starts < 1 || d < 0 || halo < 0 || body < 1 || id_bits < 1 ||
      depth_bits < 1 || 1 + kd_bits + (cross ? 2 : 1) + id_bits > 32 ||
      !valid_segments(segments, seg_len, body, halo) || (cross != 0) != (cont != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t live = num_windows * body - (d + 1);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* s = static_cast<const int32_t*>(starts);
  auto* rec = static_cast<uint32_t*>(meta);
  const unsigned grid = grid_for(num_windows * segments);
  const auto str = static_cast<uint32_t>(stride);
  if (class_bytes == 1) {
    fused_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint8_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else if (class_bytes == 2) {
    fused_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const uint16_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else if (class_bytes == 4) {
    fused_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        tab, static_cast<const int32_t*>(windows), num_windows, width, halo, body, str, d, id_bits,
        depth_bits, kd_bits, cross, segments, seg_len, s, num_starts, live, rec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<grid_for(num_starts), kThreads, 0, st>>>(
      s, rec, static_cast<const int32_t*>(outrows), num_starts, live, id_bits, kd_bits, cross,
      static_cast<int32_t*>(die_pos), static_cast<bool*>(has), static_cast<int32_t*>(m_start),
      static_cast<int32_t*>(m_end), static_cast<int32_t*>(m_val), static_cast<bool*>(cont));
  return static_cast<int>(cudaGetLastError());
}
