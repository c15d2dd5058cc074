// Sequential DFA scan from an arbitrary entry state for Hopper (sm_90a), in
// two forms, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, scan_dfa.py binds it).
//
// What it replaces.  ahocorasick_tpu/core/stream.py _seqscan_jit `run`
// (:96-141), the lax.scan behind the stream cursors' small feeds, legacy
// resumes, the shortest cursor's restart scan and the row-compressed gold
// branch, in both of its forms (dense table, RowTable);
// ahocorasick_tpu/ops/scan_dfa.py dfa_states (:26-34), the dense form again;
// and ahocorasick_tpu/ops/scan_dfa.py shortest_states (:37-58), the lagged
// restart of the leftmost-shortest matcher, which is the RowTable form over
// the padded dfa_next with row_id[s] = match_len[s] > 0 ? 0 : s (the wrapper
// builds that map once per table).
//
// What it computes.  Arrival states s_1 .. s_N from the entry state s_0:
//     dense:     s_i = table[s_{i-1} * A + c_i]
//     RowTable:  s_i = rows[row_id[s_{i-1}] * A + c_i]
// over int32 tables with row stride A and uint8, uint16 or int32 classes
// (the kernels are templated on the class width: six instantiations of each,
// no widening pass).  The carry to the next feed is s_N.
//
// Two forms, one per kind of table.
//   * seq_states_spec: speculate and repair, for any table, and the only
//     correct form for one that does not synchronize (the shortest
//     matcher's restart table, where the state depends on where earlier
//     matches ended).  Pass 1 cuts the N classes into C = ceil(N/K) chunks of
//     K (the last one shorter) and walks each chunk in a lane of its own:
//     chunk 0 from s_0, so it is exact, every other chunk from the root, a
//     guess.  It is the lane scan below with lanes of K and no warm-up
//     (d = 0).  Pass 2, one
//     warp launched behind it on the same stream, walks the chunks in order:
//     chunk c's true entry e is the state before it (out[cK - 1], read after
//     chunk c - 1 was repaired); if e is the root the chunk is right,
//     otherwise lane 0 walks it from e, overwriting out, up to the first
//     position where the new state equals the recorded one: from there on
//     the recorded states are the run from that state, so they are exact.
//     A walk that never meets them runs to the chunk's end, and the next
//     chunk's entry is its last state.  Exactness follows from determinism
//     alone.  Runs that enter a chunk in different states usually meet soon
//     (on a goto closure within d classes; on the restart table a few
//     classes past the next match), so the time is about K + sum of the
//     repairs dependent lookups, against N for one thread; a text that keeps
//     the runs apart (keywords "ab", "ba" over "abab..." at an odd K) costs
//     the serial walk plus pass 1, and stays exact.  The repair warp stages
//     the heads of 32 chunks at a time (kHead classes and recorded states
//     each) into shared memory with coalesced loads, issued for the next 32
//     chunks before lane 0 walks these, and a longer repair's further
//     classes and states a tile of kRepairTile at a time, so lane 0's chain
//     waits only on the table.  It writes each chunk's repair length (the
//     states it overwrote) to an int32[C] side output when one is given.
//     Where N <= K there is one chunk and no repair launch: one lane walks
//     the whole text.  The wrapper picks K (kernels/scan_dfa.py
//     spec_chunk_len).  Speculate and repair takes rows: `rescan_serial`,
//     the chunk stitch's rescan for a table that does not synchronize
//     (kernels/stitch.py; it replaces ahocorasick_tpu/ops/stitch.py
//     stitched_states, :68), cuts each of R rows of L classes (the stitch's
//     chunks) into sub-chunks of K, lane 0 of row r from entry[r] and every
//     other lane from the root, and launches one repair warp a row (a grid
//     of R one-warp blocks), so the rows repair in parallel; a row of at
//     most K classes is one lane and needs no repair.  The stitch's sigma
//     maps (stitch.cu state_maps_all) take their reference runs from it,
//     every entry the root.  Its repair lengths are int32[R, ceil(L / K)];
//     seq_states_spec is the one-row case, entered in s0.
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
//     loop is tile.cuh's planes lane with the state as its value: the
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
// one-row case whose entry is s0, and pass 1 of speculate and repair the
// case of d = 0: lanes of K, no warm-up, every lane past a row's first from
// the root.  16-byte stores
// need K % 4 == 0 and N % 4 == 0 as well, since rows start at c*K.
// Indices are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
// Pass 1's block: one warp, so that its few lanes (one a sub-chunk) spread over
// the SMs instead of sharing the L1 and L2 bandwidth of a few.
constexpr int kSpecBlock = 32;
constexpr int kRepairChunks = 32;  // chunks whose heads the repair warp stages at once
constexpr int kHead = 32;          // classes and states of a chunk's head: one a lane
constexpr int kRepairTile = 256;   // positions staged at a time past a head

// One step of a scan: the row of s (issued as soon as s is known), then the
// entry of class c in it.
template <bool kRows>
__device__ __forceinline__ uint32_t step(const uint32_t* __restrict__ table,
                                         const uint32_t* __restrict__ row_id, uint32_t s,
                                         uint32_t c, uint32_t num_classes) {
  const uint32_t row = kRows ? __ldg(row_id + s) : s;
  return __ldg(table + (static_cast<uint64_t>(row) * num_classes + c));
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// The lane scan over `rows` rows of `row_len` classes each (the last row
// ends at n), every row cut into lanes_per_row lanes of lane_len positions:
// lane g (the thread's global index) is lane j = g % lanes_per_row of row r =
// g / lanes_per_row and scans [j*L, min((j+1)*L, row_len)) of its row.  Lane
// 0 of row r starts from entry[r] (where `entry` is null: s0 for row 0 and
// the root for every other row), every other lane from the root warmed over
// the d classes before its segment, which lie in the same row (j*L >= L >=
// d).  Every thread of a warp runs the tile loop as often as its longest lane
// (the stores are warp-wide); a lane past the end loads nothing and stores
// nothing.
template <bool kRows, typename T>
__global__ void __launch_bounds__(kThreads)
sync_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ row_id,
            const T* __restrict__ cls, int64_t n, int64_t rows, int64_t row_len,
            int64_t lanes_per_row, const uint32_t* __restrict__ entry, uint32_t s0,
            uint32_t num_classes, int depth, int lane_len, bool vec,
            uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[kThreads * tile::kPitch];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t r = g / lanes_per_row;
  const int64_t in_row = (g - r * lanes_per_row) * lane_len;
  const int64_t start = r * row_len + in_row;
  const int64_t avail = lmin(row_len - in_row, n - start);
  const int len = r >= rows || avail <= 0 ? 0
                  : (avail < lane_len ? static_cast<int>(avail) : lane_len);
  uint32_t s = 0;
  if (len > 0 && in_row == 0) {
    s = entry != nullptr ? __ldg(entry + r) : (r == 0 ? s0 : 0u);
  } else if (len > 0) {  // warm up from the root over the d classes before the segment
    for (int t0 = 0; t0 < depth; t0 += tile::kTileSteps) {
      const int k = min(tile::kTileSteps, depth - t0);
      tile::ClassWords<T> c;
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
    tile::ClassWords<T> c;
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

// Launches the lane scan of `rows` rows over n classes in blocks of `block`
// <= kThreads threads (a multiple of 32); false where the grid is too large.
template <bool kRows, typename T>
bool launch_sync(const uint32_t* table, const uint32_t* row_id, const T* cls, int64_t n,
                 int64_t rows, int64_t row_len, const uint32_t* entry, uint32_t s0,
                 uint32_t num_classes, int depth, int lane_len, uint32_t* out,
                 cudaStream_t stream, int block = kThreads) {
  const int64_t per_row = (row_len + lane_len - 1) / lane_len;
  if (per_row > (int64_t{1} << 62) / rows) return false;
  const int64_t blocks = (rows * per_row + block - 1) / block;
  if (blocks > 2147483647) return false;
  // Every run (a lane's tile, at r*row_len + j*L + a multiple of 16) is
  // 16-byte aligned and a multiple of 4 words long where L, row_len and n are
  // multiples of 4.
  const bool vec = row_len % 4 == 0 && n % 4 == 0 && tile::vec_runs(4, lane_len, out);
  sync_kernel<kRows, T><<<static_cast<unsigned>(blocks), block, 0, stream>>>(
      table, row_id, cls, n, rows, row_len, per_row, entry, s0, num_classes, depth, lane_len,
      vec, out);
  return true;
}

// The repair warp's loads of the heads of chunks c0 .. c0 + 31 (kHead
// positions each; lane t takes position t) and of the recorded state before
// each of them (lane t: before chunk c0 + t), into registers.
template <typename T>
__device__ __forceinline__ void fetch_heads(const T* __restrict__ cls, const uint32_t* out,
                                            int64_t n, int64_t chunk_len, int64_t chunks,
                                            int64_t c0, int lane,
                                            uint32_t (&head_cls)[kRepairChunks],
                                            uint32_t (&head_rec)[kRepairChunks],
                                            uint32_t& entry) {
#pragma unroll
  for (int j = 0; j < kRepairChunks; ++j) {
    const int64_t p = (c0 + j) * chunk_len + lane;
    const bool ok = c0 + j < chunks && lane < chunk_len && p < n;
    head_cls[j] = ok ? static_cast<uint32_t>(__ldg(cls + p)) : 0u;
    head_rec[j] = ok ? out[p] : 0u;
  }
  entry = c0 + lane < chunks ? out[(c0 + lane) * chunk_len - 1] : 0u;
}

// Lane 0's walk position, whether it met the recorded states, and its state,
// to every lane.
__device__ __forceinline__ void broadcast(int64_t& t, bool& met, uint32_t& s) {
  t = __shfl_sync(tile::kFull, static_cast<long long>(t), 0);
  met = __shfl_sync(tile::kFull, static_cast<int>(met), 0) != 0;
  s = __shfl_sync(tile::kFull, s, 0);
}

// Pass 2 of speculate and repair, one warp a row (block r repairs row r of
// n classes, at r*n): chunks 1 .. C-1 of the row's `out` (pass 1's states,
// chunk c walked from the root) repaired in order, as the source note says.
// repair (null: not wanted) gets each chunk's repair length, C a row.
// Control flow is warp-uniform: lane 0 walks, and the warp learns where it
// stopped by shuffles.  kOne: one row, at the pointers as given.  With the
// row offsets nvcc keeps the walk's pointers in uniform registers, and the
// repair of one row of 32 Mi units of the 10k restart table took 2.093 ms of
// card time where it took 1.854 without them (NVIDIA H100 80GB HBM3, 700 W;
// torch.profiler), so a one-row launch takes the instantiation without.
template <bool kRows, typename T, bool kOne>
__global__ void __launch_bounds__(32)
repair_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ row_id,
              const T* __restrict__ cls, int64_t n, int64_t chunk_len, uint32_t num_classes,
              uint32_t* out, int32_t* repair) {
  __shared__ uint32_t head_cls[kRepairChunks][kHead];
  __shared__ uint32_t head_rec[kRepairChunks][kHead];
  __shared__ uint32_t entry_rec[kRepairChunks];
  __shared__ uint32_t tile_cls[kRepairTile];
  __shared__ uint32_t tile_rec[kRepairTile];
  const int lane = threadIdx.x;
  const int64_t chunks = (n + chunk_len - 1) / chunk_len;
  if (!kOne) {
    const int64_t r = blockIdx.x;
    cls += r * n;
    out += r * n;
    if (repair != nullptr) repair += r * chunks;
  }
  if (lane == 0 && repair != nullptr) repair[0] = 0;
  // Lane t holds position t of each head of the next 32 chunks, and the
  // recorded state before chunk c0 + t: loads issued one group ahead, so
  // that they complete while lane 0 walks this group.
  uint32_t next_cls[kRepairChunks], next_rec[kRepairChunks], next_entry = 0;
  uint32_t carry = 0;    // the last state of a chunk repaired to its end
  bool carried = false;  // whether the chunk before this one was
  for (int64_t c0 = 1 - kRepairChunks; c0 < chunks; c0 += kRepairChunks) {
    if (c0 >= 1) {
      __syncwarp();  // the last group's walks are done with the shared heads
#pragma unroll
      for (int j = 0; j < kRepairChunks; ++j) {
        head_cls[j][lane] = next_cls[j];
        head_rec[j][lane] = next_rec[j];
      }
      entry_rec[lane] = next_entry;
      __syncwarp();
    }
    if (c0 + kRepairChunks < chunks)
      fetch_heads(cls, out, n, chunk_len, chunks, c0 + kRepairChunks, lane, next_cls, next_rec,
                  next_entry);
    if (c0 < 1) continue;
    const int group = static_cast<int>(lmin(kRepairChunks, chunks - c0));
    for (int j = 0; j < group; ++j) {
      const int64_t base = (c0 + j) * chunk_len;
      const int64_t len = lmin(chunk_len, n - base);
      uint32_t s = carried ? carry : entry_rec[j];
      int64_t t = 0;  // positions overwritten
      bool met = s == 0u;  // entered at the root: pass 1 walked it right
      if (!met) {
        const int head = static_cast<int>(lmin(kHead, len));
        if (lane == 0) {
          for (; t < head; ++t) {
            s = step<kRows>(table, row_id, s, head_cls[j][t], num_classes);
            if (s == head_rec[j][t]) {
              met = true;
              break;
            }
            out[base + t] = s;
          }
        }
        broadcast(t, met, s);
        while (!met && t < len) {  // past the head: a staged tile at a time
          const int m = static_cast<int>(lmin(kRepairTile, len - t));
#pragma unroll
          for (int q = 0; q < kRepairTile / 32; ++q) {
            const int i = q * 32 + lane;
            const bool ok = i < m;
            const uint32_t c = ok ? static_cast<uint32_t>(__ldg(cls + base + t + i)) : 0u;
            const uint32_t rec = ok ? out[base + t + i] : 0u;
            tile_cls[i] = c;
            tile_rec[i] = rec;
          }
          __syncwarp();
          if (lane == 0) {
            int i = 0;
            for (; i < m; ++i) {
              s = step<kRows>(table, row_id, s, tile_cls[i], num_classes);
              if (s == tile_rec[i]) {
                met = true;
                break;
              }
              out[base + t + i] = s;
            }
            t += i;
          }
          broadcast(t, met, s);
          __syncwarp();  // the tile is restaged for the next one
        }
      }
      carried = !met;
      carry = s;
      if (lane == 0 && repair != nullptr) repair[c0 + j] = static_cast<int32_t>(t);
    }
  }
}

// Speculate and repair over `rows` rows of row_len classes (n = rows *
// row_len), sub-chunks of chunk_len <= row_len: pass 1 is the lane scan with
// one lane a sub-chunk and no warm-up (lane 0 of row r from entry[r], or s0
// and then the root where `entry` is null; every other lane from the root),
// pass 2 one repair warp a row behind it on the same stream.
template <bool kRows, typename T>
int launch_spec(const uint32_t* table, const uint32_t* row_id, const void* cls, int64_t rows,
                int64_t row_len, const uint32_t* entry, uint32_t s0, uint32_t num_classes,
                int64_t chunk_len, uint32_t* out, int32_t* repair, cudaStream_t stream) {
  const auto* c = static_cast<const T*>(cls);
  if (rows > 2147483647 || !launch_sync<kRows, T>(table, row_id, c, rows * row_len, rows,
                                                   row_len, entry, s0, num_classes, 0,
                                                   static_cast<int>(chunk_len), out, stream,
                                                   kSpecBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_len < row_len) {
    if (rows == 1) {
      repair_kernel<kRows, T, true><<<1, 32, 0, stream>>>(table, row_id, c, row_len, chunk_len,
                                                          num_classes, out, repair);
    } else {
      repair_kernel<kRows, T, false><<<static_cast<unsigned>(rows), 32, 0, stream>>>(
          table, row_id, c, row_len, chunk_len, num_classes, out, repair);
    }
  } else if (repair != nullptr) {
    cudaError_t err = cudaMemsetAsync(repair, 0, sizeof(int32_t) * rows, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spec_form(const uint32_t* table, const uint32_t* row_id, const void* cls, int64_t n,
                     uint32_t num_classes, uint32_t s0, int64_t chunk_len, uint32_t* out,
                     int32_t* repair, cudaStream_t stream) {
  return row_id != nullptr
             ? launch_spec<true, T>(table, row_id, cls, 1, n, nullptr, s0, num_classes,
                                    chunk_len, out, repair, stream)
             : launch_spec<false, T>(table, row_id, cls, 1, n, nullptr, s0, num_classes,
                                     chunk_len, out, repair, stream);
}

}  // namespace

// Speculate and repair: out int32[n] from the entry state s0, over `table`
// (row_id null: dense int32[S, A]; otherwise the distinct rows int32[R, A]
// and row_id int32[S]) and classes of cls_bytes bytes (1, 2 or 4), in
// chunks of chunk_len >= 1 (one chunk where chunk_len >= n); repair int32[C]
// (C = ceil(n / min(chunk_len, n))) receives each chunk's repair length, or
// is null.  Two launches (one where C = 1) on `stream`, no host
// synchronization.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int seq_states_spec(const void* table, const void* row_id, const void* cls,
                               int cls_bytes, int64_t n, int num_classes, int s0,
                               int64_t chunk_len, void* out, void* repair, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || num_classes < 1 || s0 < 0 || chunk_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t k = chunk_len < n ? chunk_len : n;
  if (k > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* rid = static_cast<const uint32_t*>(row_id);
  auto* states = static_cast<uint32_t*>(out);
  auto* rep = static_cast<int32_t*>(repair);
  auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<uint32_t>(num_classes);
  const auto e = static_cast<uint32_t>(s0);
  switch (cls_bytes) {
    case 1:
      return launch_spec_form<uint8_t>(tab, rid, cls, n, a, e, k, states, rep, st);
    case 2:
      return launch_spec_form<uint16_t>(tab, rid, cls, n, a, e, k, states, rep, st);
    case 4:
      return launch_spec_form<uint32_t>(tab, rid, cls, n, a, e, k, states, rep, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lane scan of a `depth`-synchronizing table: out int32[n] from s0 over
// `table` (row_id null: dense; otherwise a RowTable, as seq_states_spec) and
// int32 classes, with the synchronizing depth d >= 1 and the lane length L >=
// d.  Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it does not take.
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
          ? launch_sync<true>(tab, rid, c, n, 1, n, nullptr, e, a, depth, lane_len, states, st)
          : launch_sync<false>(tab, rid, c, n, 1, n, nullptr, e, a, depth, lane_len, states, st);
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
      num_chunks * chunk_len, num_chunks, chunk_len, static_cast<const uint32_t*>(entry), 0,
      static_cast<uint32_t>(num_classes), depth, lane_len, static_cast<uint32_t*>(out),
      static_cast<cudaStream_t>(stream));
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}

// The rescan of the chunk stitch for any table (kernels/stitch.py rescan,
// no sync_depth), speculate and repair by rows: out int32[num_chunks,
// chunk_len], chunk c walked from entry[c] (entry null: every chunk from the
// root, the sigma maps' reference runs) over the dense table int32[S,
// num_classes], in sub-chunks of min(sub_len, chunk_len) classes; repair
// int32[num_chunks, ceil(chunk_len / that)] receives each sub-chunk's repair
// length, or is null.  Two launches (one where a chunk is one sub-chunk) on
// `stream`, no host synchronization.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int rescan_serial(const void* table, const void* cls, const void* entry,
                             int64_t num_chunks, int64_t chunk_len, int num_classes,
                             int64_t sub_len, void* out, void* repair, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 1 || num_classes < 1 || sub_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t k = sub_len < chunk_len ? sub_len : chunk_len;
  if (k > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  return launch_spec<false, uint32_t>(
      static_cast<const uint32_t*>(table), nullptr, cls, num_chunks, chunk_len,
      static_cast<const uint32_t*>(entry), 0u, static_cast<uint32_t>(num_classes), k,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(repair),
      static_cast<cudaStream_t>(stream));
}
