// The PFAC v2 walk for Hopper (sm_90a): persistent blocks whose warps each
// take a contiguous span of starts, a dense prefix pass over staged classes,
// a warp queue of the walks that live past the prefix, lanes that refill
// from it, and a count that makes one atomic add a block.
// csrc/pfac_scan.cu instantiates it; bench/scan_variants.cu's pfac_queue
// runs its other widths for the A/B.
//
// The function (csrc/pfac_scan.cu's source note): start i walks the ranked
// trie from the root over cls[i], cls[i + 1], ...; one prefix load gives the
// state after k classes and the matches of depths 1..k (bit 28 + j: a match
// at depth k - j); then one trie load a depth, a match being `st >=
// threshold`, until the dead state or the depth.  Bit (L-1) % 32 of plane
// word (L-1) / 32 of column i is a match of length L.
//
// The design, against what held the first one back (one thread a start over
// 131,072 blocks: each warp ran as long as its longest walk, most lanes dead
// after the prefix; 32 prefix lookups a warp through L1; the count's block
// atomics on one address):
//   * Persistent blocks: the grid fills the SMs once
//     (kernels/scan_pfac.launch_shape), and warp g takes starts [g * span,
//     (g + 1) * span), span a multiple of 16.  No block barrier after the
//     prefix table is staged: a warp never waits for another.
//   * The prefix pass: the warp stages the classes of its next kBatch =
//     32 * kPerLane starts (and k - 1 more) in shared memory with 16-byte
//     loads, and each lane takes kPerLane consecutive starts: k-grams from
//     the stage, one prefix lookup each, their plane words stored with
//     16-byte stores (zeros included: the planes past the first), or their
//     popcounts summed.  On word soup most walks end here (the 10k cell:
//     78% of starts).
//   * The prefix table is staged once a block where launch_shape finds room
//     beside the warps' areas (4 A^k bytes; 78.7 KB for the 10k dictionary);
//     otherwise it is read with __ldg.  A warp's lookups then cost a few
//     shared-memory bank conflicts, not up to 32 L1 wavefronts.
//   * Lanes that refill: the starts whose walk goes on join the warp's queue
//     (a ballot-free prefix sum of each lane's count: shuffles); each round
//     the idle lanes take the queue's next walks (a ballot and a popcount
//     rank), then every live lane makes one trie load.  The warp runs the
//     prefix pass again whenever fewer than 32 walks wait, so lanes idle
//     only in the warp's last rounds, not behind each warp's longest walk.
//     A walk reads its classes past the prefix with __ldg (L1: the stage
//     just read them) and stores a plane word itself only where it found a
//     match past the prefix, after the prefix pass's store of the same word
//     (program order within the warp); most walks store nothing.
//   * Count: each lane sums the popcounts of all its words (a queued walk
//     carries no prefix bits, so nothing counts twice); the block reduces
//     once and makes one 64-bit atomic add.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pfac {

constexpr int kStateBits = 28;  // ops/scan_pfac2._STATE_BITS
constexpr uint32_t kStateMask = (1u << kStateBits) - 1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory on the H100
constexpr int kMaxK = 3;  // ops/scan_pfac2.build_ranked: k <= 3

// Everything a launch needs; span (starts a warp) and the grid come from
// kernels/scan_pfac.launch_shape.
struct Walk {
  const uint32_t* trie;  // uint32[S, stride], ranked
  const uint32_t* prefix;  // uint32[prefix_entries] = A^k packed entries
  const void* cls;  // n + depth padded classes of C
  uint32_t* planes;  // uint32[num_planes, n] (planes mode)
  unsigned long long* count;  // the total (count mode)
  int64_t n;
  int64_t span;
  int stride;
  uint32_t threshold, dead, num_classes;
  int depth, k, num_planes;
  int prefix_entries;
};

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// The launch's arguments as the C entry points take them; prefix_entries 0
// (refused by valid) when A^k passes 2^30.
inline Walk make_walk(const void* trie, int stride, const void* prefix, int64_t threshold,
                      int64_t dead, const void* cls, int64_t n, int depth, int k,
                      int num_classes, int num_planes, int64_t span, void* out) {
  Walk w{};
  w.trie = static_cast<const uint32_t*>(trie);
  w.prefix = static_cast<const uint32_t*>(prefix);
  w.cls = cls;
  w.planes = static_cast<uint32_t*>(out);
  w.count = static_cast<unsigned long long*>(out);
  w.n = n;
  w.span = span;
  w.stride = stride;
  w.threshold = static_cast<uint32_t>(threshold);
  w.dead = static_cast<uint32_t>(dead);
  w.num_classes = static_cast<uint32_t>(num_classes);
  w.depth = depth;
  w.k = k;
  w.num_planes = num_planes;
  int64_t entries = 1;
  for (int j = 0; j < k && entries <= (int64_t{1} << 30); ++j) entries *= num_classes;
  w.prefix_entries = entries <= (int64_t{1} << 30) ? static_cast<int>(entries) : 0;
  return w;
}

// A warp's shared memory: the stage of kBatch + k - 1 classes, and the
// queue's start offsets and packed (state | prefix bits << 28) entries.
template <typename C, int kPerLane>
struct WarpArea {
  static constexpr int kBatch = 32 * kPerLane;
  static constexpr int kQueue = 32 + kBatch;  // < 32 wait before a pass adds kBatch
  static constexpr int kStage = round16((kBatch + kMaxK - 1) * static_cast<int>(sizeof(C)));
  static constexpr int kBytes = kStage + 8 * kQueue;
};

// Dynamic shared-memory bytes of a launch: the prefix table (if staged) and
// the warps' areas.
template <typename C, int kThreads, int kPerLane>
constexpr int smem_bytes(int prefix_entries, bool prefix_shared) {
  return (prefix_shared ? round16(4 * prefix_entries) : 0) +
         (kThreads / 32) * WarpArea<C, kPerLane>::kBytes;
}

// count elements of src (global) into dst (shared, 16-byte aligned) by the
// `threads` threads numbered t: 16-byte loads where src is aligned,
// element loads for the rest.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count, int t, int threads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
    const int vecs = static_cast<int>(count * sizeof(T)) >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = t; i < vecs; i += threads) d[i] = __ldg(s + i);
    done = static_cast<int>((vecs << 4) / sizeof(T));
  }
  for (int i = done + t; i < count; i += threads) dst[i] = src[i];
}

template <typename C, bool kCount, bool kPrefixShared, int kThreads, int kPerLane, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks) walk_kernel(const Walk w) {
  using Area = WarpArea<C, kPerLane>;
  constexpr int kCls = kPerLane + kMaxK - 1;  // the classes a lane's k-grams read
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_sums[kThreads / 32];
  const int prefix_bytes = kPrefixShared ? round16(4 * w.prefix_entries) : 0;
  if (kPrefixShared) {
    stage(reinterpret_cast<uint32_t*>(smem), w.prefix, w.prefix_entries, threadIdx.x, kThreads);
    __syncthreads();
  }
  const uint32_t* prefix = kPrefixShared ? reinterpret_cast<const uint32_t*>(smem) : w.prefix;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned char* area = smem + prefix_bytes + warp * Area::kBytes;
  C* s_cls = reinterpret_cast<C*>(area);
  uint32_t* q_off = reinterpret_cast<uint32_t*>(area + Area::kStage);
  uint32_t* q_sw = q_off + Area::kQueue;
  // The warp's starts [begin, begin + len) as offsets from begin: its
  // classes and plane columns start there.
  const int64_t begin = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp) * w.span;
  const uint32_t len =
      begin < w.n ? static_cast<uint32_t>(min(w.span, w.n - begin)) : 0u;
  const C* wcls = static_cast<const C*>(w.cls) + begin;
  uint32_t* wplanes = kCount ? nullptr : w.planes + begin;
  // Plane rows take 16-byte stores when every row start is 16-byte aligned.
  const bool vec4 = !kCount && kPerLane % 4 == 0 && (w.n & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(w.planes) & 15u) == 0;
  unsigned long long pop = 0;
  uint32_t pos = 0;  // the next prefix pass's first start (warp-uniform)
  int qhead = 0, qsize = 0;  // the queue (warp-uniform)
  bool live = false;
  uint32_t st = 0u, word = 0u, off = 0u;  // off: the walk's start - begin
  int kk = 0;

  while (len != 0u) {
    if (qsize < 32 && pos < len) {
      // The prefix pass over starts [pos, pos + kBatch).
      const uint32_t staged = static_cast<uint32_t>(
          min(static_cast<int64_t>(Area::kBatch + w.k - 1), w.n + w.depth - begin - pos));
      stage(s_cls, wcls + pos, static_cast<int>(staged), lane, 32);
      __syncwarp();
      const int first = kPerLane * lane;
      uint32_t cl[kCls];
#pragma unroll
      for (int j = 0; j < kCls; ++j) cl[j] = static_cast<uint32_t>(s_cls[first + j]);
      uint32_t words[kPerLane], sts[kPerLane];
      int nlive = 0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        uint32_t gram = cl[i];
#pragma unroll
        for (int j = 1; j < kMaxK; ++j) {
          if (j < w.k) gram = gram * w.num_classes + cl[i + j];
        }
        const bool valid = pos + first + i < len;
        const uint32_t packed = valid ? (kPrefixShared ? prefix[gram] : __ldg(prefix + gram))
                                      : w.dead;  // past the span: no bits, not live
        sts[i] = w.k < w.depth ? packed & kStateMask : w.dead;
        words[i] = valid ? __brev(packed >> kStateBits) >> (32 - w.k) : 0u;
        nlive += sts[i] != w.dead;
      }
      if (kCount) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) pop += __popc(words[i]);
      } else {
        const uint32_t s0 = pos + first;
        for (int p = 0; p < w.num_planes; ++p) {
          uint32_t* row = wplanes + static_cast<int64_t>(p) * w.n + s0;
          if (vec4 && s0 + kPerLane <= len) {
#pragma unroll
            for (int i = 0; i + 3 < kPerLane; i += 4) {
              *reinterpret_cast<uint4*>(row + i) =
                  p ? make_uint4(0u, 0u, 0u, 0u)
                    : make_uint4(words[i], words[i + 1], words[i + 2], words[i + 3]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              if (s0 + i < len) row[i] = p ? 0u : words[i];
            }
          }
        }
      }
      // Queue the walks that go on: each lane's slots after the lanes below.
      int incl = nlive;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int slot = qhead + qsize + incl - nlive;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (sts[i] != w.dead) {
          const int e = slot < Area::kQueue ? slot : slot - Area::kQueue;
          q_off[e] = pos + first + i;
          q_sw[e] = sts[i] | ((kCount ? 0u : words[i]) << kStateBits);
          ++slot;
        }
      }
      qsize += __shfl_sync(kFull, incl, 31);
      pos += Area::kBatch;
      __syncwarp();  // the queue is written and the stage read
    }
    // The idle lanes take the queue's next walks.
    const unsigned idle = __ballot_sync(kFull, !live);
    const int take = min(__popc(idle), qsize);
    if (take > 0) {
      const int rank = __popc(idle & below);
      if (!live && rank < take) {
        const int e = qhead + rank < Area::kQueue ? qhead + rank : qhead + rank - Area::kQueue;
        off = q_off[e];
        const uint32_t sw = q_sw[e];
        st = sw & kStateMask;
        word = sw >> kStateBits;
        kk = w.k;
        live = true;
      }
      qhead = qhead + take < Area::kQueue ? qhead + take : qhead + take - Area::kQueue;
      qsize -= take;
      __syncwarp();  // the entries are read before a pass overwrites them
    }
    if (!__any_sync(kFull, live)) {
      if (pos < len) continue;  // the queue is empty: another prefix pass
      break;
    }
    if (live) {
      // One trie load; a plane word is done when its 32 depths are, and at
      // the walk's end.  It is stored only where it differs from what the
      // prefix pass stored there: the prefix bits in plane 0, zeros after.
      if ((kk & 31) == 0) {
        if (kCount) {
          pop += __popc(word);
        } else if (kk == 32 ? (word >> w.k) != 0u : word != 0u) {
          wplanes[static_cast<int64_t>((kk >> 5) - 1) * w.n + off] = word;
        }
        word = 0u;
      }
      const uint32_t c = static_cast<uint32_t>(__ldg(wcls + off + kk));
      st = __ldg(w.trie + (static_cast<uint64_t>(st) * static_cast<uint32_t>(w.stride) + c));
      word |= static_cast<uint32_t>(st >= w.threshold) << (kk & 31);
      ++kk;
      if (kk >= w.depth || st == w.dead) {
        if (kCount) {
          pop += __popc(word);
        } else if (kk <= 32 ? (word >> w.k) != 0u : word != 0u) {
          wplanes[static_cast<int64_t>((kk - 1) >> 5) * w.n + off] = word;
        }
        live = false;
      }
    }
  }
  if (kCount) {
    for (int o = 16; o > 0; o >>= 1) pop += __shfl_down_sync(kFull, pop, o);
    if (lane == 0) s_sums[warp] = pop;
    __syncthreads();
    if (warp == 0) {
      pop = lane < kThreads / 32 ? s_sums[lane] : 0ull;
      for (int o = 16; o > 0; o >>= 1) pop += __shfl_down_sync(kFull, pop, o);
      if (lane == 0 && pop != 0ull) atomicAdd(w.count, pop);
    }
  }
}

// The checks every launch shares; then the kernel's shared-memory limit,
// the launch.
template <typename C, bool kCount, bool kPrefixShared, int kThreads, int kPerLane, int kBlocks>
int launch_typed(const Walk& w, unsigned grid, cudaStream_t stream) {
  const int smem = smem_bytes<C, kThreads, kPerLane>(w.prefix_entries, kPrefixShared);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = walk_kernel<C, kCount, kPrefixShared, kThreads, kPerLane, kBlocks>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// The shape: depth and planes as the wrappers check them, k <= 3, a span a
// multiple of 16 starts (each warp's classes and plane columns start on a
// 16-byte boundary when the tensors do) whose warps cover the starts, the
// walk's offsets within 32 bits.
template <int kThreads, int kPerLane>
bool valid(const Walk& w, unsigned grid) {
  if (w.n < 1 || w.stride < 1 || w.depth < 1 || w.k < 1 || w.k > w.depth || w.k > kMaxK ||
      w.num_planes < (w.depth + 31) / 32 || w.prefix_entries < 1 || grid < 1u)
    return false;
  const int64_t warps = static_cast<int64_t>(grid) * (kThreads / 32);
  return w.span >= 16 && w.span % 16 == 0 && w.span + w.depth + 32 * kPerLane < (int64_t{1} << 32) &&
         warps * w.span >= w.n;
}

template <bool kCount, int kThreads, int kPerLane, int kBlocks>
int launch(const Walk& w, int cls_bytes, bool prefix_shared, unsigned grid,
           cudaStream_t stream) {
  if (!valid<kThreads, kPerLane>(w, grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (cls_bytes == 1) {
    return prefix_shared
               ? launch_typed<uint8_t, kCount, true, kThreads, kPerLane, kBlocks>(w, grid, stream)
               : launch_typed<uint8_t, kCount, false, kThreads, kPerLane, kBlocks>(w, grid, stream);
  }
  if (cls_bytes == 2) {
    return prefix_shared
               ? launch_typed<uint16_t, kCount, true, kThreads, kPerLane, kBlocks>(w, grid, stream)
               : launch_typed<uint16_t, kCount, false, kThreads, kPerLane, kBlocks>(w, grid,
                                                                                   stream);
  }
  if (cls_bytes == 4) {
    return prefix_shared
               ? launch_typed<int32_t, kCount, true, kThreads, kPerLane, kBlocks>(w, grid, stream)
               : launch_typed<int32_t, kCount, false, kThreads, kPerLane, kBlocks>(w, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pfac
