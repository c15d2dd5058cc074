// Chunk stitching by state maps for Hopper (sm_90a): the sigma map of every
// chunk, in two forms, and the fold of the maps into each chunk's entry
// state, behind a plain C interface loaded with ctypes
// (ahocorasick_tpu_torch/kernels/build.py builds it, kernels/stitch.py binds
// it).  The rescan of every chunk from its entry state is seq_scan.cu's, in
// two forms too: the lane scan with one row a chunk (`rescan`) and speculate
// and repair by rows (`rescan_serial`).
//
// What it replaces.  ahocorasick_tpu/ops/stitch.py: chunk_state_maps (:33, a
// lax.scan over the chunk columns carrying a (C, S) lane matrix), entry_states
// (:48, a lax.associative_scan that composes whole maps) and stitched_states
// (:68, a vmapped lax.scan); and the same three loops inside the shard_map
// body of ahocorasick_tpu/parallel/sharding.py sharded_arrival_states
// (:230-253), which is the C = 1 case per shard.
//
// What it computes, over a dense int32[S, A] transition table (row stride A)
// and int32[C, K] classes:
//     state_maps:  sigma[c, s] = the state reached from s over chunk c
//     entry_fold:  entry[0] = s0, entry[c] = sigma[c-1][entry[c-1]]
//     rescan:      states[c, j] = arrival state after class j of chunk c,
//                  walking from entry[c]
// so that rescan(table, cls, entry_fold(state_maps(table, cls), s0)) equals
// the one sequential scan of the flattened classes from s0, bit for bit.
//
// The two forms of the sigma map.
//   * state_maps_all, for any table (the shortest matcher's restart table
//     does not synchronize), by meeting a reference run.  Let R be chunk c's
//     run from the root.  A lane entered in state s that holds R[i] after
//     class i follows R from there (the walk is deterministic), so
//     sigma[c, s] = R[K - 1]; only the lanes that have not met R yet need a
//     walk.  Launch 1 and 2 (seq_scan.cu rescan_serial, entry null) write R
//     for every chunk into scratch int32[C, K], speculate and repair by
//     rows.  Launch 3 (meet_kernel, on the same stream: no host
//     synchronization) runs one thread per (chunk, entry state) lane, a
//     block's lanes from one chunk, whose classes and R go through shared
//     memory kMeetTile at a time with coalesced loads; the root's lane is R
//     and done at once, every other lane steps from its own state and
//     compares it with R after each class, and the first equality ends it.
//     A block stages no further tile once __syncthreads_or finds no live
//     lane.  A lane that reaches K unmet (a sink, or runs kept apart such as
//     "ab", "ba" over "abab...") stores its own state: exact for any table,
//     as the first design (C*K*S dependent lookups, one K-long chain a lane:
//     2.22 ms at C = 1, K = 32 Ki, S = 65,536 on the 10k table, NVIDIA H100
//     80GB HBM3, 700.00 W; now an A/B arm, bench/scan_variants.cu
//     maps_first) was.  On a goto closure every live lane meets R within d
//     classes and a zero-filled padding row within d + 1; on the restart
//     table a few classes past the next keyword end, where its state starts
//     to depend only on where that match ended.  The side output `meet`
//     (null: not wanted) gets each lane's meet position: the first i with
//     the lane's state after class i equal to R[i] (0 for the root's lane),
//     K where it never met.  sigma leaves as 16-byte stores from a staged
//     block where S % 4 == 0.
//   * state_maps, the synchronized form, for a table declared
//     d-synchronizing from every state reachable from the root (a goto
//     closure, d = max_depth: after any d classes the state is the longest
//     suffix of them that is a keyword prefix, whatever state they were read
//     from).  Phase 1 (agree_kernel) walks all S lanes of each chunk over its
//     first t = min(K, d + 1) classes and folds each warp's least and
//     greatest state (__reduce_min_sync / __reduce_max_sync) into the chunk's
//     pair with one atomicMin / atomicMax a warp; the entry point sets the
//     pairs with cudaMemsetAsync on the stream first.  Phase 2
//     (settle_kernel, the next launch on the same stream: no host
//     synchronization) reads the pair.  Where least == greatest == v, every
//     lane holds v after t classes, so sigma[c, s] = walk(v, cls[t:K]) for
//     every s and any table; v was reached from the root's lane, so the
//     declaration gives walk(v, cls[t:K]) = walk(v, cls[K-d:K]) once
//     K - t >= d, and the block walks v over [max(t, K - d), K) (at most d
//     dependent loads, the same for every thread) and stores the one value,
//     16 bytes a store where S % 4 == 0.  Where they differ (a padding row
//     that never converges, a sink), every lane walks its whole chunk from
//     its entry state, as the first design did (phase 1 stores nothing, so
//     the common case writes sigma once): exact for any table.  A live row
//     agrees after d classes and a zero-filled padding row (every class to
//     the root) one class later, hence t = d + 1.  The work falls from C*K*S
//     lookups to S*(d + 1) + d lookups a chunk and 4*C*S bytes out: two
//     launches, two short chains and the stores, 0.016 ms of card time at the
//     shape above (0.043 ms through the wrapper, whose host time is most of a
//     call).  At many short chunks the S*(d + 1) lookups a chunk dominate:
//     2.78 ms at C = 1,024, K = 256 (same card).
// The fold, entry_fold, is a chain of C dependent loads (4*C bytes out),
// bound by the latency of a sigma load; the JAX code composes whole maps in
// log depth (C*S*log2 C lookups) because a TPU has no cheap serial chain,
// and the contract is only the entry vector.  Its first design walked the
// chain in one thread (0.640 ms at C = 4,096 of the demo dictionary's 32 Mi
// units, 156 ns a chunk).  Now one block speculates and repairs: lane p of
// P <= 1,024 lanes owns chunks [p per, (p + 1) per), per = ceil(C / P).
// Pass 1: lane 0 folds its chunks from s0 and lane p > 0 from the guess
// sigma_{p per - 1}[s0], recording the entry of each chunk, so per + 1
// dependent loads.  The guess is right whenever that map is constant on the
// states that reach it: every map of a d-synchronizing table over a chunk
// longer than d is constant, and most maps of the restart table are.  Pass
// 2, warp 0 in lane order: lane q's true entry is lane q - 1's exit; where it
// differs from q's guess (a ballot of the lanes' tests, searched a word a
// lane), lane 0 of the warp re-folds q from it until its state equals the
// recorded entry of a chunk, from where the records are the fold of that
// state; a re-fold that leaves q's run unmet has given q a new exit and goes
// on into q + 1, stopping at its first chunk where q + 1's guess was right.
// Each chunk's record is loaded beside its sigma load, so a re-fold costs
// one dependent load a chunk.  Exact for any maps; where none is constant
// (random sigma) it walks about C + per dependent loads in all, as the first
// design walked C.  `repair` (null: not wanted) gets each lane's re-folded
// length.
// All flat indices are 64-bit: C*S and S*A pass 2**31 at the
// 1M-keyword dictionary.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMapThreads = 256;
constexpr int kMapTile = 1024;
constexpr int kMeetTile = 256;  // classes and reference states staged at a time
constexpr int kFoldThreads = 1024;  // the fold's lanes: one block

// Every thread of the block walks its state s over the classes row[begin,
// end); the classes go through `tile` kMapTile at a time with coalesced
// loads.  Threads with `active` false only help stage.  All threads of the
// block must call it (it synchronizes).
__device__ __forceinline__ int32_t walk(const int32_t* __restrict__ table,
                                        const int32_t* __restrict__ row, int64_t begin,
                                        int64_t end, int64_t num_classes, int32_t s, bool active,
                                        int32_t* __restrict__ tile) {
  for (int64_t base = begin; base < end; base += kMapTile) {
    const int len = static_cast<int>(end - base < kMapTile ? end - base : kMapTile);
    for (int i = threadIdx.x; i < len; i += kMapThreads) tile[i] = row[base + i];
    __syncthreads();
    if (active) {
      for (int i = 0; i < len; ++i)
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile[i]));
    }
    __syncthreads();  // the next tile's loads overwrite `tile`
  }
  return s;
}

// Launch 3 of state_maps_all: lane s of chunk c walks from s until its
// state equals the chunk's reference run `run` (R, from the root) at the
// same position, as the source note says; sigma[c, s] is R[K - 1] for a lane
// that met, its own state for one that did not.
__global__ void __launch_bounds__(kMapThreads)
meet_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
            const int32_t* __restrict__ run, int64_t chunk_len, int64_t num_states,
            int64_t num_classes, int64_t blocks_per_chunk, bool vec,
            int32_t* __restrict__ sigma, int32_t* __restrict__ meet) {
  __shared__ int32_t tile_cls[kMeetTile];
  __shared__ int32_t tile_run[kMeetTile];
  __shared__ __align__(16) int32_t staged[kMapThreads];
  const int64_t chunk = blockIdx.x / blocks_per_chunk;
  const int64_t first = (blockIdx.x % blocks_per_chunk) * kMapThreads;
  const int64_t lane = first + threadIdx.x;
  const bool in = lane < num_states;
  const int32_t* row = cls + chunk * chunk_len;
  const int32_t* ref = run + chunk * chunk_len;
  int32_t s = in ? static_cast<int32_t>(lane) : 0;
  // The root's lane is R itself: it meets at position 0.
  int64_t at = in && lane == 0 ? 0 : chunk_len;
  bool live = in && lane != 0 && chunk_len > 0;
  for (int64_t base = 0; base < chunk_len; base += kMeetTile) {
    // The same answer in every thread, and the barrier before the tiles
    // are overwritten.
    if (!__syncthreads_or(live)) break;
    const int len = static_cast<int>(chunk_len - base < kMeetTile ? chunk_len - base : kMeetTile);
    for (int i = threadIdx.x; i < len; i += kMapThreads) {
      tile_cls[i] = row[base + i];
      tile_run[i] = ref[base + i];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < len; ++i) {
        s = __ldg(table + (static_cast<int64_t>(s) * num_classes + tile_cls[i]));
        if (s == tile_run[i]) {
          live = false;
          at = base + i;
          break;
        }
      }
    }
  }
  const int32_t w = at < chunk_len ? __ldg(ref + chunk_len - 1) : s;
  int32_t* out = sigma + chunk * num_states;
  if (vec) {  // S % 4 == 0: the block's lanes as whole 16-byte words
    staged[threadIdx.x] = w;
    __syncthreads();
    const int64_t at4 = first + 4 * static_cast<int64_t>(threadIdx.x);
    if (threadIdx.x < kMapThreads / 4 && at4 < num_states)
      *reinterpret_cast<int4*>(out + at4) = *reinterpret_cast<const int4*>(staged + 4 * threadIdx.x);
  } else if (in) {
    out[lane] = w;
  }
  if (meet != nullptr && in) meet[chunk * num_states + lane] = static_cast<int32_t>(at);
}

// Phase 1: the lanes over the first t classes; each warp's least and
// greatest state into the chunk's (lo, hi).
__global__ void __launch_bounds__(kMapThreads)
agree_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
             int64_t chunk_len, int64_t num_states, int64_t num_classes,
             int64_t blocks_per_chunk, int64_t t, int32_t* __restrict__ lo,
             int32_t* __restrict__ hi) {
  __shared__ int32_t tile[kMapTile];
  const int64_t chunk = blockIdx.x / blocks_per_chunk;
  const int64_t lane = (blockIdx.x % blocks_per_chunk) * kMapThreads + threadIdx.x;
  const bool live = lane < num_states;
  const int32_t s = walk(table, cls + chunk * chunk_len, 0, t, num_classes,
                         live ? static_cast<int32_t>(lane) : 0, live, tile);
  const int least = __reduce_min_sync(0xffffffffu, live ? s : INT32_MAX);
  const int most = __reduce_max_sync(0xffffffffu, live ? s : -1);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(lo + chunk, least);
    atomicMax(hi + chunk, most);
  }
}

// Phase 2: the tail of one agreed state, or every lane's own walk.
__global__ void __launch_bounds__(kMapThreads)
settle_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ cls,
              int64_t chunk_len, int64_t num_states, int64_t num_classes,
              int64_t blocks_per_chunk, int64_t t, int64_t depth,
              const int32_t* __restrict__ lo, const int32_t* __restrict__ hi, bool vec,
              int32_t* __restrict__ sigma) {
  __shared__ int32_t tile[kMapTile];
  const int64_t chunk = blockIdx.x / blocks_per_chunk;
  const int64_t first = (blockIdx.x % blocks_per_chunk) * kMapThreads;
  const int64_t lane = first + threadIdx.x;
  const bool live = lane < num_states;
  const int32_t* row = cls + chunk * chunk_len;
  int32_t* out = sigma + chunk * num_states;
  const int32_t v = lo[chunk];
  if (v == hi[chunk]) {  // the same for the whole block
    const int64_t tail = chunk_len - depth > t ? chunk_len - depth : t;
    const int32_t w = walk(table, row, tail, chunk_len, num_classes, v, true, tile);
    if (vec) {  // S % 4 == 0: the block's lanes as whole 16-byte words
      const int64_t at = first + 4 * static_cast<int64_t>(threadIdx.x);
      if (threadIdx.x < kMapThreads / 4 && at < num_states)
        *reinterpret_cast<int4*>(out + at) = make_int4(w, w, w, w);
    } else if (live) {
      out[lane] = w;
    }
  } else {
    const int32_t s = walk(table, row, 0, chunk_len, num_classes,
                           live ? static_cast<int32_t>(lane) : 0, live, tile);
    if (live) out[lane] = s;
  }
}

// The first set bit at or after `from` of the lanes' wrong-guess mask
// (`words` words of 32 lanes), or INT32_MAX: one word a lane of warp 0.
__device__ __forceinline__ int next_wrong(const uint32_t* wrong, int words, int from) {
  const int lane = threadIdx.x & 31;
  const int at = from >> 5;
  uint32_t w = lane < words && lane >= at ? wrong[lane] : 0u;
  if (lane == at) w &= ~0u << (from & 31);
  const uint32_t any = __ballot_sync(0xffffffffu, w != 0u);
  if (any == 0u) return INT32_MAX;
  const int word = __ffs(static_cast<int>(any)) - 1;
  const uint32_t bits = __shfl_sync(0xffffffffu, w, word);
  return (word << 5) + __ffs(static_cast<int>(bits)) - 1;
}

// The fold by speculate and repair, as the source note says: lane p of one
// block folds chunks [p per, (p + 1) per) from its guess, then warp 0
// repairs the lanes whose guess was wrong, in lane order.
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const int32_t* __restrict__ sigma, int64_t num_chunks, int64_t num_states,
            int32_t s0, int64_t per, int lanes, int32_t* entry, int32_t* repair) {
  __shared__ int32_t guess_s[kFoldThreads];
  __shared__ int32_t exit_s[kFoldThreads];
  __shared__ uint32_t wrong_s[kFoldThreads / 32];
  const int p = threadIdx.x;
  const int64_t first = p * per;
  const int64_t end = first + per < num_chunks ? first + per : num_chunks;
  // Pass 1: lane p > 0 guesses that sigma_{first - 1} is constant, so that
  // it maps the true entry as it maps s0.
  int32_t s = s0;
  if (p > 0 && first < num_chunks) s = __ldg(sigma + ((first - 1) * num_states + s0));
  const int32_t guess = s;
  for (int64_t c = first; c < end; ++c) {
    entry[c] = s;
    if (c + 1 < num_chunks) s = __ldg(sigma + (c * num_states + s));
  }
  guess_s[p] = guess;
  exit_s[p] = s;
  if (repair != nullptr && p < lanes) repair[p] = 0;
  __syncthreads();
  const bool wrong = p > 0 && p < lanes && guess != exit_s[p - 1];
  const uint32_t bits = __ballot_sync(0xffffffffu, wrong);
  if ((p & 31) == 0) wrong_s[p >> 5] = bits;
  __syncthreads();
  if (p >= 32) return;
  // Pass 2, warp 0: lane q's true entry is lane q - 1's exit, final by now.
  // Lane 0 of the warp re-folds from it until a state equals the entry that
  // pass 1 recorded for its chunk (from there on the records are the fold of
  // that state).  A re-fold that passes the end of q's run unmet has given q
  // a new exit and goes on into q + 1, whose guess is that chunk's record: it
  // stops there if q + 1's guess was right.  The lanes it ended in or before
  // are settled; the next wrong lane is searched after them.
  const int words = (blockDim.x + 31) >> 5;
  for (int q = next_wrong(wrong_s, words, 1); q < lanes;) {
    int settled = 0;
    if (p == 0) {
      const int64_t from = q * per;
      int32_t t = exit_s[q - 1];
      int32_t rec = guess_s[q];  // the record of chunk `from`
      int64_t c = from;
      for (; c < num_chunks && rec != t; ++c) {
        // The next record's load goes out beside the sigma load: one
        // dependent load a chunk, as in pass 1.
        const int32_t next = c + 1 < num_chunks ? entry[c + 1] : 0;
        entry[c] = t;
        if (c + 1 < num_chunks) t = __ldg(sigma + (c * num_states + t));
        rec = next;
      }
      settled = static_cast<int>(c / per);  // the lane of the chunk that met, or `lanes`
      if (repair != nullptr) {
        for (int l = q; l <= settled && l < lanes; ++l) {
          const int64_t end = (l + 1) * per < c ? (l + 1) * per : c;
          repair[l] = static_cast<int32_t>(end - l * per);
        }
      }
    }
    q = next_wrong(wrong_s, words, __shfl_sync(0xffffffffu, settled, 0) + 1);
  }
}

constexpr int64_t kMaxGrid = 2147483647;  // blocks along x

// Blocks per chunk of the sigma kernels, or -1 past the grid's limit.
int64_t map_blocks(int64_t num_chunks, int64_t num_states) {
  const int64_t per = (num_states + kMapThreads - 1) / kMapThreads;
  return per > kMaxGrid / num_chunks ? -1 : per;
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 = the
// launch was accepted).  The caller validates shapes and types and launches
// only non-empty work (num_chunks >= 1; chunk_len may be 0 for the maps).

// seq_scan.cu: the rescan by speculate and repair (entry null: from the root).
extern "C" int rescan_serial(const void* table, const void* cls, const void* entry,
                             int64_t num_chunks, int64_t chunk_len, int num_classes,
                             int64_t sub_len, void* out, void* repair, int device,
                             void* stream);

// sigma int32[num_chunks, num_states] for any table, by meeting the
// reference runs.  `table` is int32[num_states, num_classes] (the row stride
// is num_classes), `cls` int32[num_chunks, chunk_len]; `run` is scratch
// int32[num_chunks, chunk_len] (unused where chunk_len is 0) for the
// reference runs, walked by speculate and repair in sub-chunks of sub_len;
// meet int32[num_chunks, num_states] receives each lane's meet position, or
// is null.  Three launches (one where chunk_len is 0 or a chunk is one
// sub-chunk: two) on `stream`, no host synchronization.
extern "C" int state_maps_all(const void* table, const void* cls, int64_t num_chunks,
                              int64_t chunk_len, int64_t num_states, int num_classes,
                              int64_t sub_len, void* run, void* sigma, void* meet, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 0 || chunk_len > 2147483647 || num_states < 1 ||
      num_states > 2147483647 || num_classes < 1 || sub_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = map_blocks(num_chunks, num_states);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_len > 0) {
    const int rc = rescan_serial(table, cls, nullptr, num_chunks, chunk_len, num_classes,
                                 sub_len, run, nullptr, device, stream);
    if (rc != 0) return rc;
  }
  const bool vec = num_states % 4 == 0 && reinterpret_cast<uintptr_t>(sigma) % 16 == 0;
  meet_kernel<<<static_cast<unsigned>(per * num_chunks), kMapThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(run), chunk_len, num_states, num_classes, per, vec,
      static_cast<int32_t*>(sigma), static_cast<int32_t*>(meet));
  return static_cast<int>(cudaGetLastError());
}

// The synchronized form: sigma as state_maps_all's from the same table and
// classes, given the synchronizing depth d >= 1 and `agree`, int32[2 *
// num_chunks] of scratch (the chunks' least states, then their greatest),
// set here.
extern "C" int state_maps(const void* table, const void* cls, int64_t num_chunks,
                          int64_t chunk_len, int64_t num_states, int num_classes, int depth,
                          void* agree, void* sigma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || chunk_len < 0 || num_states < 1 || num_states >= 0x7f7f7f7f ||
      num_classes < 1 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = map_blocks(num_chunks, num_states);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* lo = static_cast<int32_t*>(agree);
  auto* hi = lo + num_chunks;
  // lo = 0x7f7f7f7f, above every state; hi = -1, below every state.
  err = cudaMemsetAsync(lo, 0x7f, 4 * num_chunks, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(hi, 0xff, 4 * num_chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t t = chunk_len < depth + 1 ? chunk_len : depth + 1;
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* c = static_cast<const int32_t*>(cls);
  const auto grid = static_cast<unsigned>(per * num_chunks);
  agree_kernel<<<grid, kMapThreads, 0, st>>>(tab, c, chunk_len, num_states, num_classes, per, t,
                                             lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = num_states % 4 == 0 && reinterpret_cast<uintptr_t>(sigma) % 16 == 0;
  settle_kernel<<<grid, kMapThreads, 0, st>>>(tab, c, chunk_len, num_states, num_classes, per, t,
                                              depth, lo, hi, vec, static_cast<int32_t*>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// entry int32[num_chunks] from sigma int32[num_chunks, num_states], by
// speculate and repair over at most `lanes` (1 .. 1024) lanes of
// ceil(num_chunks / lanes) chunks; repair int32[ceil(num_chunks / per)]
// receives each lane's re-folded length (0 where its guess was right), or is
// null.  One launch.
extern "C" int entry_fold(const void* sigma, int64_t num_chunks, int64_t num_states, int s0,
                          int lanes, void* entry, void* repair, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks < 1 || num_states < 1 || s0 < 0 || s0 >= num_states || lanes < 1 ||
      lanes > kFoldThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = (num_chunks + lanes - 1) / lanes;
  const int used = static_cast<int>((num_chunks + per - 1) / per);
  fold_kernel<<<1, (used + 31) / 32 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sigma), num_chunks, num_states, s0, per, used,
      static_cast<int32_t*>(entry), static_cast<int32_t*>(repair));
  return static_cast<int>(cudaGetLastError());
}
