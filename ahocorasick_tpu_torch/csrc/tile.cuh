// The lane-scan building blocks shared by the scans of packed_scan.cu,
// huge_scan.cu, rowdfa2_scan.cu, table_sharded.cu and wwl_scan.cu (their
// source notes say why each is there): the table lookup and the warm-up from
// the root, a block's sum of its lanes' counts, the segment of a window a lane
// scans, a lane's classes read a 32-bit word at a time, a warp's 16-step store
// tile in shared memory that leaves as whole sectors, and the two lane loops
// built from them: the count lane (packed_scan.cu's count, huge_scan.cu's
// count-packed and split counts, rowdfa2_scan.cu's count and table_sharded.cu's
// counts) and the planes lane (packed_scan.cu's planes, huge_scan.cu's
// hotstate plane and split emit planes, rowdfa2_scan.cu's planes,
// table_sharded.cu's planes).  The lane loops take the table as a type that
// says how many classes a step consumes (kStride) and reads a step's entry:
// Dense here for one flat table and Stride2 for the stride-2 row table (a pair
// of classes a step, two words), table_sharded.cu's Shards for row shards in
// separate allocations.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tile {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileSteps = 16;           // body steps per store tile
constexpr int kPitch = kTileSteps + 1;   // words per lane row: 17, an odd bank stride
constexpr int kChunks = kTileSteps / 4;  // 16-byte chunks per run
constexpr int kCountSteps = 32;          // a count lane's register tile of classes

template <typename T>
__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ table, uint32_t s, T c,
                                           uint32_t num_classes) {
  return __ldg(table + (static_cast<uint64_t>(s) * num_classes + c));
}

// The state after `halo` classes read from the root (state 0, a compiler
// invariant); smask is all ones where the table holds bare states.
template <typename T>
__device__ __forceinline__ uint32_t warm_up(const uint32_t* __restrict__ table,
                                            const T* __restrict__ row, int halo,
                                            uint32_t num_classes, uint32_t smask) {
  uint32_t s = 0;
  for (int t = 0; t < halo; ++t) s = lookup(table, s, row[t], num_classes) & smask;
  return s;
}

// One flat table uint32[S * A], the lane loops' table type for a table in one
// allocation: entry s*A + c is state s's word for class c.  A step consumes
// one class and reads one word (kStride 1: lookup(s, c)).
struct Dense {
  static constexpr int kStride = 1;
  const uint32_t* table;
  uint32_t num_classes;
  template <typename T>
  __device__ __forceinline__ uint32_t lookup(uint32_t s, T c) const {
    return tile::lookup(table, s, c, num_classes);
  }
};

// A stride-2 step's two words: w = state2 | emit2 << state_bits (the state
// and emit mask after both classes) and e1 (the emit mask after the first).
struct Pair {
  uint32_t w;
  uint32_t e1;
};

// The stride-2 row table uint32[S*A, A+1] (rowdfa2_scan.cu): row (s, c0)
// holds w in column c1 < A and e1 in column A.  A step consumes a pair of
// classes (kStride 2: step(s, c0, c1)) and reads both words of row (s, c0),
// two independent loads issued together; next(s, c0, c1) reads w alone (the
// warm-up).  Halo, segment starts and lengths, and so every tile's length,
// are even.
struct Stride2 {
  static constexpr int kStride = 2;
  const uint32_t* table;
  uint32_t num_classes;
  template <typename T>
  __device__ __forceinline__ const uint32_t* row(uint32_t s, T c0) const {
    return table + (static_cast<uint64_t>(s) * num_classes + c0) * (num_classes + 1u);
  }
  template <typename T>
  __device__ __forceinline__ uint32_t next(uint32_t s, T c0, T c1) const {
    return __ldg(row(s, c0) + c1);
  }
  template <typename T>
  __device__ __forceinline__ Pair step(uint32_t s, T c0, T c1) const {
    const uint32_t* r = row(s, c0);
    return {__ldg(r + c1), __ldg(r + num_classes)};
  }
};

// The entry a lane reads at step t of its classes (anything with an at(t)):
// a word, or a Pair for a stride-2 table; word_of gives the word whose low
// bits are the next state.
template <typename Table, typename Classes>
__device__ __forceinline__ auto step_at(const Table& table, uint32_t s, const Classes& cls,
                                        int t) {
  if constexpr (Table::kStride == 1) {
    return table.lookup(s, cls.at(t));
  } else {
    return table.step(s, cls.at(t), cls.at(t + 1));
  }
}
__device__ __forceinline__ uint32_t word_of(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t word_of(Pair p) { return p.w; }

// warm_up over any table type, kStride classes a step (the halo a multiple
// of it).
template <typename Table, typename T>
__device__ __forceinline__ uint32_t warm_up(const Table& table, const T* __restrict__ row,
                                            int halo, uint32_t smask) {
  uint32_t s = 0;
  for (int t = 0; t < halo; t += Table::kStride) {
    if constexpr (Table::kStride == 1) {
      s = table.lookup(s, row[t]) & smask;
    } else {
      s = table.next(s, row[t], row[t + 1]) & smask;
    }
  }
  return s;
}

// Adds every thread's value to *out with one 64-bit atomic per block of
// kBlock threads (in-warp shuffles, then the warps' sums).  Every thread of
// the block must call it.
template <int kBlock>
__device__ __forceinline__ void block_add(unsigned long long v, unsigned long long* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  __shared__ unsigned long long warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0 && v != 0ull) atomicAdd(out, v);
  }
}

// K lanes per window of `body` positions, `seg_len` each (the last one
// shorter): 1 and body, or, when halo >= 1, K in 2..4 and seg_len a multiple
// of 4 with (K - 1) * seg_len < body <= K * seg_len.
inline bool valid_segments(int segments, int seg_len, int body, int halo) {
  const bool one = segments == 1 && seg_len == body;
  const bool split = segments >= 2 && segments <= 4 && halo >= 1 && seg_len % 4 == 0 &&
                     (segments - 1) * seg_len < body && segments * seg_len >= body;
  return one || split;
}

// Lane g of a grid of num_windows * segments lanes scans window b = g /
// segments from body position `start`, `len` positions (0 past the last
// window).  Its warm-up classes are row[start, start + halo), its body
// classes follow them.
struct Segment {
  int64_t b;
  int start;
  int len;
};

__device__ __forceinline__ Segment segment_of(int64_t g, int64_t num_windows, int width,
                                              int halo, int segments, int seg_len) {
  const int64_t b = g / segments;
  const int start = static_cast<int>(g - b * segments) * seg_len;
  const int len = b < num_windows ? min(seg_len, width - halo - start) : 0;
  return {b, start, len};
}

// The classes of a tile of up to kSteps steps, held as the aligned 32-bit
// words that contain them (kPer classes a word) and funnel-shifted into place
// by at().  load() reads no word past the one that holds the tile's last
// class, and none at all for n <= 0: a lane whose row is done loads nothing.
template <typename T, int kSteps = kTileSteps>
struct ClassWords {
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  static constexpr int kWords = kSteps / kPer;
  static constexpr uint32_t kMask =
      static_cast<uint32_t>((1ull << (8 * sizeof(T))) - 1ull);
  uint32_t raw[kWords + 1];
  uint32_t shift;

  __device__ __forceinline__ void load(const T* first, int n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(first);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    shift = static_cast<uint32_t>(a & 3u) * 8u;
    const int num_words =
        n > 0 ? (static_cast<int>(a & 3u) + n * static_cast<int>(sizeof(T)) + 3) / 4 : 0;
#pragma unroll
    for (int k = 0; k <= kWords; ++k) raw[k] = k < num_words ? __ldg(words + k) : 0u;
  }

  // Class t of the tile (t a compile-time constant after unrolling).
  __device__ __forceinline__ uint32_t at(int t) const {
    const uint32_t word = __funnelshift_r(raw[t / kPer], raw[t / kPer + 1], shift);
    return (word >> (8 * sizeof(T) * (t % kPer))) & kMask;
  }
};

// One lane of a count kernel: lane g (the thread's global index) scans its
// segment (segment_of) of `table` (a table type: Dense, Stride2, Shards) and
// returns the sum of the values of the entries it reads at its body
// positions; smask is all ones where the table holds bare states.  No stores
// and no shuffles in the loop, so each lane runs its own length.  A 32-class
// tile's values add up in Sum, the lane's total in 64 bits: Sum may be 32
// bits where a tile's values cannot overflow it.  The value takes one of two
// forms:
//   * Value::kGather false: value(v) of the entry v of a step (a word, or a
//     Pair for a stride-2 table), computed as it is read;
//   * Value::kGather true (one class a step): the sum over p <
//     value.planes() of value(s, p) of the state s = v & smask.  These are
//     loads (the split layout's emit table): the lane keeps the states of
//     Value::kGatherSteps steps of its tile (all 32, or 16) in registers and
//     issues their loads after those steps' lookups, all at once, so that no
//     such load sits in the chain.  A step past the lane's length keeps
//     state 0, a valid load, and adds nothing.
template <typename Sum, typename Table, typename T, typename Value>
__device__ __forceinline__ unsigned long long count_lane(
    const Table& table, const T* __restrict__ windows, int64_t num_windows, int width, int halo,
    uint32_t smask, int segments, int seg_len, Value value) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Segment sg = segment_of(g, num_windows, width, halo, segments, seg_len);
  const T* seg = windows + sg.b * width + sg.start;
  uint32_t s = sg.len > 0 ? warm_up(table, seg, halo, smask) : 0u;
  seg += halo;
  unsigned long long total = 0;
  for (int t0 = 0; t0 < sg.len; t0 += kCountSteps) {
    const int n = min(kCountSteps, sg.len - t0);
    ClassWords<T, kCountSteps> cls;
    cls.load(seg + t0, n);
    Sum sum = 0;
    if constexpr (!Value::kGather) {
#pragma unroll
      for (int t = 0; t < kCountSteps; t += Table::kStride) {
        if (t < n) {
          const auto v = step_at(table, s, cls, t);
          sum += value(v);
          s = word_of(v) & smask;
        }
      }
    } else {
      static_assert(Table::kStride == 1, "the gathered form reads one class a step");
      constexpr int kGroup = Value::kGatherSteps;  // states gathered at once
      static_assert(kCountSteps % kGroup == 0, "the groups cover the tile");
#pragma unroll
      for (int g0 = 0; g0 < kCountSteps; g0 += kGroup) {
        uint32_t state[kGroup];
#pragma unroll
        for (int t = g0; t < g0 + kGroup; ++t) {
          if (t < n) s = table.lookup(s, cls.at(t)) & smask;
          state[t - g0] = t < n ? s : 0u;
        }
        const int planes = value.planes();
        for (int p = 0; p < planes; ++p) {
#pragma unroll
          for (int t = g0; t < g0 + kGroup; ++t) {
            const Sum x = value(state[t - g0], p);
            sum += t < n ? x : Sum{0};
          }
        }
      }
    }
    total += sum;
  }
  return total;
}

// The warp's tile holds lane r's `count` words in tile[r*kPitch ...]; they go
// to out[start_r ...].  Lanes pass their start and count by shuffle.  With
// `vec`, 16-byte stores (kChunks lanes per run, so every sector is full; the
// runs must be 16-byte aligned), else 4-byte stores, kTileSteps lanes per run.
__device__ __forceinline__ void store_tile(const uint32_t* __restrict__ tile, int lane,
                                           long long start, int count, bool vec,
                                           uint32_t* __restrict__ out) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int r = q * (32 / kChunks) + lane / kChunks;
      const int w = 4 * (lane % kChunks);
      const long long dst = __shfl_sync(kFull, start, r);
      const int n = __shfl_sync(kFull, count, r);
      if (w < n) {
        const uint32_t* src = tile + r * kPitch + w;
        *reinterpret_cast<uint4*>(out + dst + w) = make_uint4(src[0], src[1], src[2], src[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kTileSteps; ++q) {
      const int r = q * (32 / kTileSteps) + lane / kTileSteps;
      const int w = lane % kTileSteps;
      const long long dst = __shfl_sync(kFull, start, r);
      const int n = __shfl_sync(kFull, count, r);
      if (w < n) out[dst + w] = tile[r * kPitch + w];
    }
  }
}

// One lane of a planes kernel: lane g (the thread's global index) scans its
// segment (segment_of) of `table` (as count_lane's) and writes, for body
// position j of window b, plane p's value to out[p*B*C + b*C + j] (B*C =
// num_windows * (width - halo); flat text order within a plane) through the
// warp's store tile of that plane.  `tiles` is the block's planes *
// blockDim.x * kPitch shared words, plane-major.  Every lane of the warp must
// call it (the stores are warp-wide).  Classes is ClassWords<T> or a type
// with the same load() and at().  The value takes one of two forms:
//   * Value::kGather false: one plane, computed from the entry of a step as
//     it is read (smask keeps the next state): value(v) of a word, or, for a
//     stride-2 table, value(pair, 0) and value(pair, 1), the words of the
//     step's two positions;
//   * Value::kGather true (one class a step): value.planes() planes,
//     value(s, p) of the state s = v & smask.  These are loads (the split
//     layout's emit table): the lane keeps its tile's states in registers
//     and loads them after the tile's lookups, all at once, so that no such
//     load sits in the chain.
// Where out is 16-byte aligned and B*C a multiple of 4 (vec_runs), every
// plane's base is too.
template <typename Classes, typename Table, typename T, typename Value>
__device__ __forceinline__ void planes_lane(const Table& table, const T* __restrict__ windows,
                                            int64_t num_windows, int width, int halo,
                                            uint32_t smask, int segments, int seg_len, bool vec,
                                            uint32_t* __restrict__ tiles,
                                            uint32_t* __restrict__ out, Value value) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Segment sg = segment_of(g, num_windows, width, halo, segments, seg_len);
  const T* seg = windows + sg.b * width + sg.start;
  uint32_t s = sg.len > 0 ? warm_up(table, seg, halo, smask) : 0u;
  seg += halo;
  uint32_t* row = tiles + threadIdx.x * kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * kPitch;
  const long long dst = sg.b * (width - halo) + sg.start;
  const int steps = __reduce_max_sync(kFull, sg.len);
  for (int t0 = 0; t0 < steps; t0 += kTileSteps) {
    const int n = min(kTileSteps, sg.len - t0);  // <= 0 once this lane is done
    Classes cls;
    cls.load(seg + t0, n);
    if constexpr (!Value::kGather) {
#pragma unroll
      for (int t = 0; t < kTileSteps; t += Table::kStride) {
        if (t < n) {
          const auto v = step_at(table, s, cls, t);
          if constexpr (Table::kStride == 1) {
            row[t] = value(v);
          } else {
            row[t] = value(v, 0);
            row[t + 1] = value(v, 1);
          }
          s = word_of(v) & smask;
        }
      }
      __syncwarp();
      store_tile(warp_tile, lane, dst + t0, n, vec, out);
    } else {
      static_assert(Table::kStride == 1, "the gathered form reads one class a step");
      uint32_t state[kTileSteps];  // state 0 past the lane's steps: a valid load
#pragma unroll
      for (int t = 0; t < kTileSteps; ++t) {
        if (t < n) s = table.lookup(s, cls.at(t)) & smask;
        state[t] = t < n ? s : 0u;
      }
      const int planes = value.planes();
      const int plane_words = blockDim.x * kPitch;
      const long long plane_stride = num_windows * (width - halo);
      for (int p = 0; p < planes; ++p) {
#pragma unroll
        for (int t = 0; t < kTileSteps; ++t) row[p * plane_words + t] = value(state[t], p);
      }
      __syncwarp();
      for (int p = 0; p < planes; ++p)
        store_tile(warp_tile + p * plane_words, lane, dst + p * plane_stride + t0, n, vec, out);
    }
    __syncwarp();  // the rows are rewritten by the next tile
  }
}

// Whether a planes kernel's runs (b*C + k*L + a multiple of kTileSteps) are
// 16-byte aligned: C and L multiples of 4 and `out` 16-byte aligned.
inline bool vec_runs(int body, int seg_len, const void* out) {
  return body % 4 == 0 && seg_len % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace tile
