// Sequential DFA scan from an arbitrary entry state for Hopper (sm_90a), in
// two forms, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_dfa.py binds it).
//
// What it replaces.  ahocorasick_tpu/core/stream.py _seqscan_jit `run`
// (:96-141), the lax.scan behind the stream cursors' small feeds, legacy
// resumes, the shortest cursor's restart scan and the row-compressed gold
// branch, in both of its forms (dense table, RowTable); and
// ahocorasick_tpu/ops/scan_dfa.py dfa_states (:26-34), the dense form again.
//
// What it computes.  Arrival states s_1 .. s_N from the entry state s_0:
//     dense:     s_i = table[s_{i-1} * A + c_i]
//     RowTable:  s_i = rows[row_id[s_{i-1}] * A + c_i]
// over int32 tables with row stride A and int32 classes.  The carry to the
// next feed is s_N.
//
// Two forms, one per kind of table.
//   * seq_states: the serial walk, the only correct form for a table that
//     does not synchronize (the shortest matcher's restart table, where the
//     state depends on where earlier matches ended).  One block; all threads
//     stage a tile of classes into shared memory with coalesced loads,
//     thread 0 walks the tile keeping the state in a register and
//     overwriting each class with its arrival state, and all threads store
//     the tile coalesced, so the chain never waits on the class stream or
//     the output stream.  Bound: one dependent load a character (two for a
//     RowTable), an L2 round trip when the table exceeds L1: about 70 ns a
//     unit on the 10k table.
//   * seq_states_sync: the lane scan, for a table that is d-synchronizing
//     (every goto closure, d = max_depth: the state after any d classes read
//     from any state is the longest suffix of those d classes that is a
//     keyword prefix, so it does not depend on the state they were read
//     from).  Lane j scans positions [j*L, min((j+1)*L, N)) with L >= d:
//     lane 0 from s_0, lane j >= 1 from the root (state 0) warmed over the
//     d classes [j*L - d, j*L), which end where its segment starts.  The
//     arrival states are exactly the serial walk's.  Each lane is still a
//     chain of dependent loads, so the time is (d + L) lookups' latency
//     while lanes are few, and the lookups' rate through L2 once they fill
//     the card: 0.010 ms on 64 Ki units and 0.26 ms on 32 Mi of the 10k
//     table (d = 12) on an H100, where the serial walk takes 4.57 ms on
//     64 Ki units.  The wrapper picks L (kernels/scan_dfa.py sync_lane_len): d,
//     rounded up to a multiple of 4, until the lanes reach SEQ_MAX_LANES
//     (the A/B of bench/scan_variants.py seq_ab sets it).  The lane
//     loop is tile.cuh's planes lane with the state as its value: int32
//     classes read into a 16-step register tile (ClassWords), the states
//     written into the warp's shared-memory store tile and stored as whole
//     sectors (16-byte stores where L, N and `out` allow).  A RowTable step
//     is two dependent loads; the row_id load of a state is issued as soon
//     as the state is known.
// The lane scan takes rows: `rescan`, the chunk stitch's rescan in its
// synchronized form (kernels/stitch.py; it replaces
// ahocorasick_tpu/ops/stitch.py stitched_states, :68), scans C chunks of K
// classes as C rows, lane 0 of row c from the chunk's entry state and every
// other lane of the row warmed inside it, so no lane crosses a chunk; a chunk
// shorter than L is one lane, the serial walk of that chunk: 0.0076 ms of
// card time at C = 1, K = 32 Ki of the 10k table (NVIDIA H100 80GB HBM3,
// 700.00 W), where the serial rescan takes 2.27.  seq_states_sync is the
// one-row case whose entry is s0.  16-byte stores need K % 4 == 0 as well,
// since rows start at c*K.
// Indices are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;

// One step of the lane scan: the row of s (issued as soon as s is known),
// then the entry of class c in it.
template <bool kRows>
__device__ __forceinline__ uint32_t step(const uint32_t* __restrict__ table,
                                         const uint32_t* __restrict__ row_id, uint32_t s,
                                         uint32_t c, uint32_t num_classes) {
  const uint32_t row = kRows ? __ldg(row_id + s) : s;
  return __ldg(table + (static_cast<uint64_t>(row) * num_classes + c));
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
seq_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ row_id,
           const int32_t* __restrict__ cls, int64_t n, int64_t num_classes, int32_t s0,
           int32_t* __restrict__ out) {
  __shared__ int32_t tile[kTile];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = s0;
  for (int64_t base = 0; base < n; base += kTile) {
    const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int i = threadIdx.x; i < len; i += kThreads) tile[i] = cls[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t s = carry;
      for (int i = 0; i < len; ++i) {
        const int64_t row = kRows ? __ldg(row_id + s) : s;
        s = __ldg(table + (row * num_classes + tile[i]));
        tile[i] = s;
      }
      carry = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) out[base + i] = tile[i];
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
}

// The lane scan over `rows` rows of `row_len` classes each, every row cut
// into lanes_per_row lanes of lane_len positions: lane g (the thread's global
// index) is lane j = g % lanes_per_row of row r = g / lanes_per_row and scans
// [j*L, min((j+1)*L, row_len)) of its row.  Lane 0 of row r starts from
// entry[r] (s0 where `entry` is null: the one-row scan), every other lane
// from the root warmed over the d classes before its segment, which lie in
// the same row (j*L >= L >= d).  Every thread of a warp runs the tile loop
// as often as its longest lane (the stores are warp-wide); a lane past the
// last row loads nothing and stores nothing.
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
sync_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ row_id,
            const uint32_t* __restrict__ cls, int64_t rows, int64_t row_len,
            int64_t lanes_per_row, const uint32_t* __restrict__ entry, uint32_t s0,
            uint32_t num_classes, int depth, int lane_len, bool vec,
            uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t r = g / lanes_per_row;
  const int64_t in_row = (g - r * lanes_per_row) * lane_len;
  const int64_t start = r * row_len + in_row;
  const int len = r >= rows ? 0
                  : (row_len - in_row < lane_len ? static_cast<int>(row_len - in_row) : lane_len);
  uint32_t s = 0;
  if (len > 0 && in_row == 0) {
    s = entry != nullptr ? __ldg(entry + r) : s0;
  } else if (len > 0) {  // warm up from the root over the d classes before the segment
    for (int t0 = 0; t0 < depth; t0 += tile::kTileSteps) {
      const int k = min(tile::kTileSteps, depth - t0);
      tile::ClassWords<uint32_t> c;
      c.load(cls + start - depth + t0, k);
#pragma unroll
      for (int t = 0; t < tile::kTileSteps; ++t) {
        if (t < k) s = step<kRows>(table, row_id, s, c.at(t), num_classes);
      }
    }
  }
  uint32_t* row = tiles + threadIdx.x * tile::kPitch;
  const uint32_t* warp_tile = tiles + (threadIdx.x - lane) * tile::kPitch;
  const int steps = __reduce_max_sync(tile::kFull, len);
  for (int t0 = 0; t0 < steps; t0 += tile::kTileSteps) {
    const int k = min(tile::kTileSteps, len - t0);  // <= 0 once this lane is done
    tile::ClassWords<uint32_t> c;
    c.load(cls + start + t0, k);
#pragma unroll
    for (int t = 0; t < tile::kTileSteps; ++t) {
      if (t < k) {
        s = step<kRows>(table, row_id, s, c.at(t), num_classes);
        row[t] = s;
      }
    }
    __syncwarp();
    tile::store_tile(warp_tile, lane, start + t0, k, vec, out);
    __syncwarp();  // the rows are rewritten by the next tile
  }
}

// Launches the lane scan of `rows` rows; false where the grid is too large.
template <bool kRows>
bool launch_sync(const uint32_t* table, const uint32_t* row_id, const uint32_t* cls,
                 int64_t rows, int64_t row_len, const uint32_t* entry, uint32_t s0,
                 uint32_t num_classes, int depth, int lane_len, uint32_t* out,
                 cudaStream_t stream) {
  const int64_t per_row = (row_len + lane_len - 1) / lane_len;
  if (per_row > (int64_t{1} << 62) / rows) return false;
  const int64_t blocks = (rows * per_row + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return false;
  // Every run (a lane's tile, at r*row_len + j*L + a multiple of 16) is
  // 16-byte aligned and a multiple of 4 words long where L and row_len are
  // multiples of 4.
  const bool vec = row_len % 4 == 0 && tile::vec_runs(4, lane_len, out);
  sync_kernel<kRows><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, row_id, cls, rows, row_len, per_row, entry, s0, num_classes, depth, lane_len, vec,
      out);
  return true;
}

}  // namespace

// out int32[n].  `row_id` null selects the dense form (`table` int32[S, A]);
// otherwise `table` is the distinct rows int32[R, A] and `row_id` int32[S].
// Returns cudaGetLastError() after the launch.
extern "C" int seq_states(const void* table, const void* row_id, const void* cls, int64_t n,
                          int num_classes, int s0, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || num_classes < 1 || s0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* rid = static_cast<const int32_t*>(row_id);
  const auto* c = static_cast<const int32_t*>(cls);
  auto* states = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (rid != nullptr) {
    seq_kernel<true><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0, states);
  } else {
    seq_kernel<false><<<1, kThreads, 0, st>>>(tab, rid, c, n, num_classes, s0, states);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lane scan of a `depth`-synchronizing table: the same arguments and
// output as seq_states, plus the synchronizing depth d >= 1 and the lane
// length L >= d.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int seq_states_sync(const void* table, const void* row_id, const void* cls,
                               int64_t n, int num_classes, int s0, int depth, int lane_len,
                               void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || num_classes < 1 || s0 < 0 || depth < 1 || lane_len < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* rid = static_cast<const uint32_t*>(row_id);
  const auto* c = static_cast<const uint32_t*>(cls);
  auto* states = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<uint32_t>(num_classes);
  const auto e = static_cast<uint32_t>(s0);
  const bool ok =
      rid != nullptr
          ? launch_sync<true>(tab, rid, c, 1, n, nullptr, e, a, depth, lane_len, states, st)
          : launch_sync<false>(tab, rid, c, 1, n, nullptr, e, a, depth, lane_len, states, st);
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}

// The rescan of the chunk stitch (kernels/stitch.py rescan, sync_depth set):
// out int32[num_chunks, chunk_len], chunk c walked from entry[c] over the
// dense `depth`-synchronizing table int32[S, num_classes], as num_chunks rows
// of the lane scan with lanes of lane_len >= depth positions.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int rescan(const void* table, const void* cls, const void* entry, int64_t num_chunks,
                      int64_t chunk_len, int num_classes, int depth, int lane_len, void* out,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 1 || num_classes < 1 || depth < 1 || lane_len < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = launch_sync<false>(
      static_cast<const uint32_t*>(table), nullptr, static_cast<const uint32_t*>(cls),
      num_chunks, chunk_len, static_cast<const uint32_t*>(entry), 0,
      static_cast<uint32_t>(num_classes), depth, lane_len, static_cast<uint32_t*>(out),
      static_cast<cudaStream_t>(stream));
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}
