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
// die in start order: the walks that die in a stretch of chars are one run
// of slots, those whose start is at most g at the stretch's last char.
// (tests/test_torch_wwl_fused.py asserts the depth property on every dense
// table those tests build, pure and mixed.  The JAX formulation, the ring,
// is the plain twin's, so the kernel is held against an independent
// algorithm.)
//
// The lanes.  Lane g takes segment g % K of window g / K (fused_segments:
// up to K = 8 lanes a window, set by the A/B below), warms from the root over
// the `halo` classes before it, and takes the slots [J(g), J(g + 1)) whose
// starts lie in its positions.  Those bounds come before the first char
// with no prepass and no search a lane from the whole array: lanes 0-15 and
// 16-31 of a warp find J of the warp's first lane and of the lane after its
// last by a 16-ary search (a ballot a step, about 7 steps at 5 Mi slots),
// then each lane binary-searches its own bound between them (about 9 steps
// at K = 8), while the warm-up's lookups run.  The lane then scans 16 chars
// a tile, the tile's entries kept in registers, with its next kAhead = 8
// starts read ahead (loads issued after the tile before, in flight during
// the lookups).  Between the lookups, which wait on each other, each char
// adds to below[j] whether its g is below next[j]: compares that wait on no
// load.  At the tile's end the starts at most g at its last char died in the
// tile, the die char of next[j] being char below[j]; the lane picks that
// entry and the one before it from its registers and writes the walk's
// record, k_die | word << kd_bits [| cross << (kd_bits + 1)] | s_pre <<
// (kd_bits + nflag), the JAX record without its `died` bit
// (fused_applicable's bit budget is what lets it fit).  More than kAhead
// deaths in a tile take a count each against the tile's entries.  At the
// row's last char every walk left ends (none do when d bounds the depth, as
// the callers' d does): a walk that did not die within d + 1 chars takes
// the zero record, as the ring's slot does.  A second launch, a thread a
// slot, gives each slot its outcome from its start's record and its
// outrows row, as the sweep does from the plane: a start outside [0, L)
// takes the sweep's zero word, and the slots of a trailing run of equal
// starts (compact_lanes' padding; kernels/scan_wwl.lane_slots finds it with
// the sortedness check) take the record of the run's first slot, which the
// lanes wrote once.
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
// kernel, with no plane: its bytes are the windows, the starts and the
// outcomes, at the 10k cell 65,537 x 537 B + 4 B x 5,242,880 + 17 B x
// 5,242,880, about 145 MB or 0.043 ms at 3.35 TB/s, against the
// plane-plus-sweep route's 0.088 ms.  The records (4 B a slot) and the
// resolve launch's reads of them are traffic above that bound.  What bounds
// it is the chain: the lanes' lookups alone, over the same segments and d
// chars past them, took 0.146 ms at K = 1 and 0.174 ms at K = 8 on the 10k
// cell, and the whole scan 0.254 ms at K = 8 with its resolve launch (0.053
// ms alone; NVIDIA H100 80GB HBM3, 700 W; PERF.md), so the fused route now
// runs below the plane and the sweep (0.2404 against 0.2757 ms at the 10k
// cell, 0.0350 against 0.0404 at baseline-4, probes/probe_wwl_fused.py) and
// FUSED_DEFAULT is True.  Its first design took 0.396 ms: a cursor over the
// sorted starts inside the chain, whose death path (a record, a store and
// the next start's load at about one char in six a lane) each warp ran at
// almost every char, three binary searches a lane before the first char,
// and a search a repeated start in its resolve launch
// (bench/scan_variants.cu wwl_fused_first).  Designs that lost their A/B:
// the tile's entries in a shared-memory row (0.302 ms at K = 8; the chain
// alone ran 0.192 ms with that row declared, 0.174 without), the deaths
// taken by the warp as a queue with shuffles (0.301 ms), the outcomes
// written by the scan itself instead of a record and a resolve launch
// (0.38-1.25 ms: the outrows gather waits in the lane), the warp's starts
// staged in shared memory (0.331 ms) and the next tile's classes read a
// tile ahead (0.304 ms).  The state lives in a register, tables are read
// through the read-only path (__ldg), flat table indices are 64-bit.

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

// The fused scan's launch: the lanes' segments, the starts they take (slots
// [0, lane_slots), sorted), the records and the outputs.  Positions and
// slots are 32-bit (the wrapper keeps B*C below 2**31).
struct Fused {
  const uint32_t* table;
  const void* windows;
  const int32_t* starts;
  const int32_t* outrows;
  uint32_t* meta;  // a record a start: uint32[lane_slots]
  int32_t* die_pos;
  bool* has;
  int32_t* m_start;
  int32_t* m_end;
  int32_t* m_val;
  bool* cont;  // null unless cross
  int64_t num_windows;
  int width, halo, body, d, id_bits, depth_bits, cross, segments, seg_len, kd_bits;
  uint32_t stride;
  int32_t lane_slots;  // the slots the lanes take
  int32_t live;        // a start at or past live (or below 0) reads the zero sweep word
};

// The first text position of lane `lane` (a window's K lanes in order, the
// windows in order), or live past the last lane: the lanes' positions are
// consecutive, so lane g's slots are [J(g), J(g + 1)) with J(g) the first
// slot whose start is at or past first_pos(g).
__device__ __forceinline__ int32_t first_pos(const Fused& f, int64_t lane) {
  if (lane >= f.num_windows * f.segments) return f.live;
  const int64_t b = lane / f.segments;
  const int64_t pos = b * f.body + (lane - b * f.segments) * static_cast<int64_t>(f.seg_len);
  return static_cast<int32_t>(pos < f.live ? pos : f.live);
}

// Starts read ahead of the lane's next death: kAhead loads issued together
// after a tile's deaths, in flight during the next tile's lookups.
constexpr int kAhead = 8;

__device__ __forceinline__ void read_ahead(const int32_t* __restrict__ starts, int32_t j,
                                           int32_t end, int32_t (&next)[kAhead]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) next[i] = j + i < end ? __ldg(starts + j + i) : INT32_MAX;
}

// The record of the walk from w at slot `slot` that died at char t of the
// lane's tile (v its entries, s_in the state before it, p its first
// position), k_die | word << kd_bits [| cross << (kd_bits + 1)] | s_pre <<
// (kd_bits + nflag): t = n (no char of the tile) or a death past d + 1 chars
// takes the zero record, as the ring's slot does.
__device__ __forceinline__ void write_record(const Fused& f,
                                             const uint32_t (&v)[tile::kTileSteps],
                                             uint32_t s_in, int32_t slot, int32_t w, int t, int n,
                                             int32_t p) {
  uint32_t die = 0u, pre = s_in;  // the die entry and the entry before it
#pragma unroll
  for (int k = 0; k < tile::kTileSteps; ++k) {
    if (k == t) die = v[k];
    if (k + 1 == t) pre = v[k];
  }
  uint32_t rec = 0u;
  if (t < n && p + t - w <= f.d) {
    const uint32_t kd = static_cast<uint32_t>(p + t - w);
    rec = kd | ((die >> (f.id_bits + f.depth_bits)) & 1u) << f.kd_bits;
    if (kd > 0) {
      const uint32_t crossed = f.cross ? (die >> (f.id_bits + f.depth_bits + 1)) & 1u : 0u;
      rec |= crossed << (f.kd_bits + 1) |
             (pre & ((1u << f.id_bits) - 1u)) << (f.kd_bits + (f.cross ? 2 : 1));
    }
  }
  f.meta[slot] = rec;
}

// The fused scan's lanes: lane g scans its segment of window g / K (warmed
// over the halo) 16 chars a tile, the tile's entries in registers, and
// counts, for each of its next kAhead starts, the tile's chars whose g is
// below that start (compares that wait on no load, between the chain's
// lookups).  A start at most g at the tile's last char died in the tile, at
// the char its count names: the lane writes its record.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Fused f) {
  using tile::kFull;
  using tile::kTileSteps;
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t g0 = g - lane;  // the warp's first lane
  const int64_t num_lanes = f.num_windows * f.segments;
  if (g0 >= num_lanes) return;  // the whole warp: no lane of it scans
  const bool active = g < num_lanes;
  const int64_t b = active ? g / f.segments : 0;
  const int col0 = active ? static_cast<int>(g - b * f.segments) * f.seg_len : 0;
  const int32_t lo = first_pos(f, g);
  const T* row = static_cast<const T*>(f.windows) + b * f.width;
  const uint32_t idmask = (1u << f.id_bits) - 1u;
  const uint32_t dmask = (1u << f.depth_bits) - 1u;
  // The warp's slot bounds, J(g0) by lanes 0-15 and J(g0 + 32) by lanes
  // 16-31, each a 16-ary search; the lanes warm up from the root meanwhile.
  const int half = lane >> 4, r = lane & 15;
  const int32_t x = first_pos(f, half ? g0 + 32 : g0);
  int32_t blo = 0, bhi = f.lane_slots;
  uint32_t s = 0;
  int t = 0;  // warm-up steps taken
  while (__any_sync(kFull, blo < bhi)) {
    if (active && t < f.halo) {
      s = __ldg(f.table + (static_cast<uint64_t>(s) * f.stride +
                           static_cast<uint32_t>(row[col0 + t]))) & idmask;
    }
    ++t;
    const int32_t span = bhi - blo;
    const int valid = span < 16 ? span : 16;
    const auto pivot = [&](int i) {
      return span <= 16 ? blo + i : blo + static_cast<int32_t>(int64_t{span} * (i + 1) / 17);
    };
    const bool less = r < valid && __ldg(f.starts + pivot(r)) < x;
    const int c = __popc((__ballot_sync(kFull, less) >> (16 * half)) & 0xffffu);
    const int32_t nlo = c > 0 ? pivot(c - 1) + 1 : blo;
    bhi = c < valid ? pivot(c) : bhi;
    blo = nlo;
  }
  const int32_t j_first = __shfl_sync(kFull, blo, 0);
  const int32_t j_last = __shfl_sync(kFull, blo, 16);
  // Each lane's own bound in [J(g0), J(g0 + 32)], a binary search.
  int32_t a0 = j_first, a1 = lane == 0 ? j_first : j_last;
  while (a0 < a1 || t < f.halo) {
    if (active && t < f.halo) {
      s = __ldg(f.table + (static_cast<uint64_t>(s) * f.stride +
                           static_cast<uint32_t>(row[col0 + t]))) & idmask;
    }
    ++t;
    if (a0 < a1) {
      const int32_t mid = a0 + (a1 - a0) / 2;
      if (__ldg(f.starts + mid) < lo) a0 = mid + 1; else a1 = mid;
    }
  }
  int32_t jc = a0;
  int32_t je = __shfl_down_sync(kFull, a0, 1);
  if (lane == 31) je = j_last;
  if (!active) return;  // (the starts outside [0, live) are the resolve launch's)
  const int last_col = f.body + f.d;  // the row's last body column
  const T* body_cls = row + f.halo;
  int col = col0;  // the body column of the tile's first char
  int32_t p = lo;  // its text position
  int32_t next[kAhead];
  read_ahead(f.starts, jc, je, next);
  while (jc < je) {
    const int n = min(kTileSteps, last_col + 1 - col);
    tile::ClassWords<T> cls;
    cls.load(body_cls + col, n);
    int below[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) below[j] = 0;
    const uint32_t s_in = s;
    int32_t gmax = INT32_MIN;
    uint32_t v[kTileSteps];
#pragma unroll
    for (int k = 0; k < kTileSteps; ++k) {
      v[k] = 0u;
      if (k < n) {
        v[k] = __ldg(f.table + (static_cast<uint64_t>(s) * f.stride + cls.at(k)));
        s = v[k] & idmask;
        gmax = p + k - static_cast<int32_t>((v[k] >> f.id_bits) & dmask);
#pragma unroll
        for (int j = 0; j < kAhead; ++j) below[j] += gmax < next[j];
      }
    }
    // At the row's last char every walk left ends: those that did not die
    // within d + 1 chars take the zero record.
    if (col + n - 1 == last_col) gmax = INT32_MAX;
    int c = 0;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) c += jc + j < je && next[j] <= gmax;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < c) write_record(f, v, s_in, jc + j, next[j], below[j], n, p);
    }
    if (c == kAhead) {  // more deaths than were read ahead: a count each
      int32_t j2 = jc + kAhead;
      for (; j2 < je; ++j2) {
        const int32_t w = __ldg(f.starts + j2);
        if (w > gmax) break;
        int a = 0;
#pragma unroll
        for (int k = 0; k < kTileSteps; ++k) {
          a += k < n && p + k - static_cast<int32_t>((v[k] >> f.id_bits) & dmask) < w;
        }
        write_record(f, v, s_in, j2, w, a, n, p);
      }
      c = j2 - jc;
    }
    jc += c;
    p += n;
    col += n;
    read_ahead(f.starts, jc, je, next);
  }
}

// A thread a slot: the outcome from its start's record (the trailing run's
// slots from the run's first slot's; a start outside [0, live) from the zero
// sweep word) and the pre-die state's outrows row.
__global__ void __launch_bounds__(kThreads) resolve_kernel(const Fused f, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t w = __ldg(f.starts + i);
  int32_t kd = 0, s_last = 0;
  bool word = false, crossed = false;
  if (w >= 0 && w < f.live) {
    const uint32_t rec = __ldg(f.meta + (i < f.lane_slots ? i : f.lane_slots - 1));
    kd = static_cast<int32_t>(rec & ((1u << f.kd_bits) - 1u));
    word = (rec >> f.kd_bits) & 1u;
    crossed = f.cross && ((rec >> (f.kd_bits + 1)) & 1u);
    s_last = static_cast<int32_t>((rec >> (f.kd_bits + (f.cross ? 2 : 1))) &
                                  ((1u << f.id_bits) - 1u));
  }
  write_outcome(f.outrows, i, w, kd, word, crossed, s_last, f.die_pos, f.has, f.m_start,
                f.m_end, f.m_val, f.cont);
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

namespace {

// The fused scan's lanes: K in 1..kMaxFusedLanes a window, the segments
// rule of kernels/scan_block.py (L a multiple of 4; K = 1 and L = body, or K
// >= 2 with a halo to warm over).
constexpr int kMaxFusedLanes = 8;

bool fused_segments_ok(int segments, int seg_len, int body, int halo) {
  const bool one = segments == 1 && seg_len == body;
  const bool split = segments >= 2 && segments <= kMaxFusedLanes && halo >= 1 &&
                     seg_len % 4 == 0 && (segments - 1) * seg_len < body &&
                     segments * seg_len >= body;
  return one || split;
}

}  // namespace

// The fused scan over chunk_classes_overlap windows (width = halo + C + d +
// 1) of a dense table, at sorted `starts`: two launches on `stream`, the
// lanes (a record into `meta`, uint32[lane_slots] scratch, for each of the
// slots [0, lane_slots) whose start lies in [0, live)) and the outcomes of
// every slot (slots [lane_slots, num_starts), a trailing run of starts equal
// to slot lane_slots - 1's, take its record).  `cont` is null unless
// `cross`.
extern "C" int wwl_scan_fused(const void* table, const void* windows, int class_bytes,
                              int64_t num_windows, int width, int halo, int stride, int d,
                              int id_bits, int depth_bits, int cross, int segments, int seg_len,
                              const void* starts, int64_t num_starts, int64_t lane_slots,
                              const void* outrows, void* meta, void* die_pos, void* has,
                              void* m_start, void* m_end, void* m_val, void* cont, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int body = width - halo - (d + 1);
  int kd_bits = 1;
  while ((1 << kd_bits) <= d) ++kd_bits;
  if (num_windows < 1 || num_starts < 1 || num_starts > 2147483647 || lane_slots < 1 ||
      lane_slots > num_starts || d < 0 || halo < 0 || body < 1 || id_bits < 1 ||
      depth_bits < 1 || id_bits + depth_bits + 1 + (cross ? 1 : 0) > 32 ||
      kd_bits + (cross ? 2 : 1) + id_bits > 32 || num_windows * body >= (int64_t{1} << 31) ||
      !fused_segments_ok(segments, seg_len, body, halo) || (cross != 0) != (cont != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fused f{};
  f.table = static_cast<const uint32_t*>(table);
  f.windows = windows;
  f.starts = static_cast<const int32_t*>(starts);
  f.outrows = static_cast<const int32_t*>(outrows);
  f.meta = static_cast<uint32_t*>(meta);
  f.die_pos = static_cast<int32_t*>(die_pos);
  f.has = static_cast<bool*>(has);
  f.m_start = static_cast<int32_t*>(m_start);
  f.m_end = static_cast<int32_t*>(m_end);
  f.m_val = static_cast<int32_t*>(m_val);
  f.cont = static_cast<bool*>(cont);
  f.num_windows = num_windows;
  f.width = width;
  f.halo = halo;
  f.body = body;
  f.d = d;
  f.id_bits = id_bits;
  f.depth_bits = depth_bits;
  f.cross = cross;
  f.segments = segments;
  f.seg_len = seg_len;
  f.kd_bits = kd_bits;
  f.stride = static_cast<uint32_t>(stride);
  f.lane_slots = static_cast<int32_t>(lane_slots);
  f.live = static_cast<int32_t>(num_windows * body - (d + 1));
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(num_windows * segments);
  if (class_bytes == 1) {
    fused_kernel<uint8_t><<<grid, kThreads, 0, st>>>(f);
  } else if (class_bytes == 2) {
    fused_kernel<uint16_t><<<grid, kThreads, 0, st>>>(f);
  } else if (class_bytes == 4) {
    fused_kernel<int32_t><<<grid, kThreads, 0, st>>>(f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<grid_for(num_starts), kThreads, 0, st>>>(f, num_starts);
  return static_cast<int>(cudaGetLastError());
}
