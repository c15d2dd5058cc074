// Hot-position compaction of END-indexed emit planes for Hopper (sm_90a),
// behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, compact.py binds it).
//
// What it replaces.  ahocorasick_tpu/ops/scan_batched.py _compact_planes
// (jit at :499-500), which XLA runs as jnp.nonzero over the planes, driven
// by planes_to_sparse (:521-547).
//
// What it computes.  Planes are uint32[P, N], plane p of position i at
// bits[p*N + i].  A position is hot when any of its P words is nonzero.  The
// output is the number of hot positions, their indices in ascending order
// (int64) and their masks hot-major (uint32[count, P]); ranks at or past the
// caller's capacity are counted but not written.
//
// How.  One launch of a single-pass chained scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016).  A block takes its tile id from an atomic
// counter (so ids follow the order in which blocks start, and every
// predecessor of a tile is already running) and reads the tile's kTile
// positions once: 16-byte loads where the alignment of N allows, scalar
// loads at the tail.  It forms the hot flags with warp ballots and counts
// each warp's hot positions per round into shared memory, where warp 0 scans
// them into the tile's own offsets.  Warp 0 publishes the tile's aggregate as
// one 64-bit descriptor (status in the top two bits), reads its 32
// predecessors' descriptors at a time until it meets an inclusive prefix
// (backing off with __nanosleep while one it needs is unpublished), and
// publishes its own inclusive prefix.  Each thread then writes the index and
// masks of its hot positions at their ranks (the tile's prefix, the offset of
// its warp's round, ballot & lanemask_lt): ascending by construction, no
// atomics on the output order.  The last tile writes the total.  With one or
// two planes the words stay in registers between the read and the write;
// with more (no main path has them) a hot position's words are read again,
// from L2, where the tile's lines were just brought.
//
// What bounds it on the H100.  Device-memory bandwidth: the planes are read
// once (4*P bytes a position) and (8 + 4*P) bytes are written per hot
// position.  On the main path (P = 1, 32 Mi positions, about 1.8 M hot)
// that is 128 MiB + 22 MB, about 0.046 ms at 3.35 TB/s.  The look-back
// replaces the former count pass, one-block scan, host read of the total and
// write pass: the planes are no longer read twice, and nothing waits on the
// host between passes (the wrapper reads the total once, after the launch).
// On the card this design's read alone runs near that bound; the look-back
// and the scattered writes after it take the rest (PERF.md).  The
// descriptors cost 8 bytes per 8,192 positions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;             // 16-byte loads per thread and plane
constexpr int kSpan = 4 * kThreads;    // positions a round
constexpr int64_t kTile = static_cast<int64_t>(kRounds) * kSpan;  // 8,192
constexpr int kHeldPlanes = 2;         // the most planes kept in registers
constexpr unsigned kFull = 0xffffffffu;

// Tile descriptor: status in bits 62-63, value (aggregate or inclusive
// prefix) below.  Zero means "not published yet".
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ void publish(unsigned long long* d, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(d) = v;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* d) {
  return *reinterpret_cast<const volatile unsigned long long*>(d);
}

// Words of positions i .. i+3 of one plane (0 past n).
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ plane, int64_t n,
                                       int64_t i, bool vec) {
  if (vec && i + 3 < n) return __ldg(reinterpret_cast<const uint4*>(plane + i));
  uint4 v;
  v.x = i < n ? __ldg(plane + i) : 0u;
  v.y = i + 1 < n ? __ldg(plane + i + 1) : 0u;
  v.z = i + 2 < n ? __ldg(plane + i + 2) : 0u;
  v.w = i + 3 < n ? __ldg(plane + i + 3) : 0u;
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t nonzero4(const uint4& v) {
  return (v.x != 0u) | (v.y != 0u) << 1 | (v.z != 0u) << 2 | (v.w != 0u) << 3;
}

// Warp-wide: the hot positions of tiles [0, tile).  Lane l reads tile
// top - l; the warp waits until every tile down to the nearest inclusive
// prefix has published (tiles past that prefix do not count) and sums down
// to it; with no prefix among the 32 it sums them all and steps back.
__device__ __forceinline__ unsigned long long look_back(const unsigned long long* desc,
                                                        int64_t tile, int lane) {
  unsigned long long exclusive = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t j = top - lane;
    unsigned long long d;
    uint32_t prefixes;
    for (unsigned sleep_ns = 32;; sleep_ns = min(2 * sleep_ns, 1024u)) {
      d = j >= 0 ? peek(desc + j) : kPrefix;
      prefixes = __ballot_sync(kFull, d >= kPrefix);
      const uint32_t upto = prefixes ? (prefixes ^ (prefixes - 1u)) : kFull;
      if (!(__ballot_sync(kFull, d == 0ull) & upto)) break;
      __nanosleep(sleep_ns);
    }
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned long long v = lane <= stop ? (d & kValue) : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    exclusive += __shfl_sync(kFull, v, 0);
    if (prefixes) return exclusive;
  }
}

// kP > 0: exactly kP planes, held in registers; kP == 0: `planes` planes,
// a hot position's words read again when its mask is written.
template <int kP>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const uint32_t* __restrict__ bits, int planes, int64_t n, int64_t cap,
                   bool vec, unsigned long long* __restrict__ desc, int64_t num_tiles,
                   int64_t* __restrict__ idx, uint32_t* __restrict__ masks,
                   int64_t* __restrict__ total) {
  constexpr int kEntries = kRounds * kWarps / 32;  // warp counts per lane of warp 0
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_hot[kRounds * kWarps];  // round-major: tile order
  __shared__ unsigned long long s_exclusive;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int64_t>(atomicAdd(desc + num_tiles, 1ull));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t first = tile * kTile + 4 * threadIdx.x;  // round r adds r * kSpan
  const int num_planes = kP > 0 ? kP : planes;

  // 1. Read the tile once: round r covers kSpan consecutive positions, 4 per
  //    thread.  Bit 4r + e of `flags`: position first + r*kSpan + e is hot.
  uint4 held[kP > 0 ? kP : 1][kRounds];
  unsigned long long flags = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = first + r * kSpan;
    uint4 any = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int p = 0; p < (kP > 0 ? kP : 1); ++p) {
      held[p][r] = load4(bits + p * n, n, i, vec);
      any.x |= held[p][r].x;
      any.y |= held[p][r].y;
      any.z |= held[p][r].z;
      any.w |= held[p][r].w;
    }
    for (int p = 1; kP == 0 && p < num_planes; ++p) {
      const uint4 v = load4(bits + p * n, n, i, vec);
      any.x |= v.x;
      any.y |= v.y;
      any.z |= v.z;
      any.w |= v.w;
    }
    flags |= static_cast<unsigned long long>(nonzero4(any)) << (4 * r);
  }

  // 2. Each warp's hot positions per round (ballots) into shared memory.
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    uint32_t warp_hot = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      warp_hot += __popc(__ballot_sync(kFull, (flags >> (4 * r + e)) & 1u));
    if (lane == 0) s_hot[r * kWarps + warp] = warp_hot;
  }
  __syncthreads();

  // 3. Warp 0: the counts' exclusive scan in tile order (in place), then the
  //    decoupled look-back for the hot positions of all earlier tiles.
  if (warp == 0) {
    uint32_t c[kEntries];
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      c[k] = s_hot[lane * kEntries + k];
      mine += c[k];
    }
    uint32_t incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const uint32_t aggregate = __shfl_sync(kFull, incl, 31);
    uint32_t run = incl - mine;
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      s_hot[lane * kEntries + k] = run;
      run += c[k];
    }
    unsigned long long exclusive = 0;
    if (tile == 0) {
      if (lane == 0) publish(desc, kPrefix | aggregate);
    } else {
      if (lane == 0) publish(desc + tile, kAggregate | aggregate);
      exclusive = look_back(desc, tile, lane);
      if (lane == 0) publish(desc + tile, kPrefix | (exclusive + aggregate));
    }
    if (lane == 0) {
      s_exclusive = exclusive;
      if (tile == num_tiles - 1) *total = static_cast<int64_t>(exclusive + aggregate);
    }
  }
  __syncthreads();

  // 4. Write each hot position at its rank: earlier tiles, earlier rounds and
  //    warps of this tile, lower lanes of this warp (ballot & lanemask_lt).
  const int64_t exclusive = static_cast<int64_t>(s_exclusive);
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t f = static_cast<uint32_t>(flags >> (4 * r)) & 0xFu;
    int64_t rank = exclusive + s_hot[r * kWarps + warp];
#pragma unroll
    for (int e = 0; e < 4; ++e) rank += __popc(__ballot_sync(kFull, (f >> e) & 1u) & lanes_below);
    const int64_t i = first + r * kSpan;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((f >> e) & 1u) {
        if (rank < cap) {
          idx[rank] = i + e;
          if (kP > 0) {
#pragma unroll
            for (int p = 0; p < (kP > 0 ? kP : 1); ++p) masks[rank * kP + p] = word(held[p][r], e);
          } else {
            for (int p = 0; p < num_planes; ++p)
              masks[rank * num_planes + p] = __ldg(bits + p * n + i + e);
          }
        }
        ++rank;
      }
    }
  }
}

}  // namespace

// Positions per tile: the caller sizes the descriptors as
// int64[max(1, ceil(n / compact_tile())) + 2].
extern "C" int compact_tile() { return static_cast<int>(kTile); }

// bits uint32[planes, n]; desc int64[num_tiles + 2] (the tiles'
// descriptors, the tile counter, then the total, which the kernel writes);
// idx int64[cap]; masks uint32[cap, planes].  Zeroes the descriptors and
// the counter and launches on `stream`; returns the first CUDA error (0 =
// accepted).
extern "C" int compact_planes(const void* bits, int planes, int64_t n, int64_t cap, void* desc,
                              void* idx, void* masks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes < 1 || n < 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t num_tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  const auto* b = static_cast<const uint32_t*>(bits);
  // Plane p starts at b + p*n: 16-byte aligned for every p when n % 4 == 0.
  const bool vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 && (planes == 1 || n % 4 == 0);
  auto* d = static_cast<unsigned long long*>(desc);
  auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(d, 0, (num_tiles + 1) * sizeof(*d), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(const uint32_t*, int, int64_t, int64_t, bool, unsigned long long*, int64_t,
                 int64_t*, uint32_t*, int64_t*) = compact_kernel<0>;
  if (planes == 1) kernel = compact_kernel<1>;
  if (planes == kHeldPlanes) kernel = compact_kernel<kHeldPlanes>;
  kernel<<<static_cast<unsigned>(num_tiles), kThreads, 0, st>>>(
      b, planes, n, cap, vec, d, num_tiles, static_cast<int64_t*>(idx),
      static_cast<uint32_t*>(masks), reinterpret_cast<int64_t*>(d + num_tiles + 1));
  return static_cast<int>(cudaGetLastError());
}
