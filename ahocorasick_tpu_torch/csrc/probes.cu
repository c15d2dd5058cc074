// Lookup-primitive probes for Hopper (sm_90a): six kernels behind a plain C
// interface loaded with ctypes (ahocorasick_tpu_torch/kernels/build.py builds
// it, kernels/probes.py binds it, ahocorasick_tpu_torch/probes/ drives it).
//
// What they replace.  The v5e micro-benchmarks of tools/probes/, thirteen
// pl.pallas_call sites that time one transition primitive each: a chained
// table lookup per step, repeated so that nothing can be hoisted.  They
// compute what the Pallas bodies compute; VMEM, lane permutes and the MXU do
// not carry over, so the placements below are this card's own.  The last two
// replace the XLA device loops of the same files (fori_loop / lax.scan).
//
// * chain_gather: independent chains  i <- (i + tab[i & (T-1)] [+ r]) & (T-1),
//   i <- tab[i]  or  i <- tab[i] % mod  for `reps` steps, one thread per
//   chain (probe.py:70, :103, :129, :239; probe2.py:39; probe3.py:77, :105;
//   probe6.py:120 k_flat_elem / k_take).  The table lies where `placement`
//   says.  In registers (T <= 128): only a reduced entry steers a chain
//   (v & (T-1) for the add ops, min(v, T-1) for load, v % mod for load_mod,
//   each below 128), so lane l packs entries l, l + 32, l + 64, l + 96 as
//   the four bytes of one word and a step is one __shfl_sync and one
//   __byte_perm; the load op reads its last step's full value with one
//   __ldg.  In shared memory: R copies of the table interleaved, word
//   x R + (lane mod R), R the largest power of two up to 32 with R 4T within
//   227 KB (shared_copies), so the lanes of a warp spread over the banks
//   (R = 32 up to 1,816 entries: no conflicts; 8 at 4,096; 1 at 57,344).
//   Where R > 1 a copy holds each entry's steering value as the byte offset
//   the lane reads next, so a step of the load ops is one dependent shared
//   load; with one copy the entries stay as they are.
//   In global memory: read with __ldg through L1 / L2 / device memory.  Out:
//   the final chain values, or their sum modulo 2^32 (probe3's (1, 1) SMEM
//   scalar, an int32 sum).
// * row_chain: K chains, a group of G lanes each (G = 1, 2, 4 or 8, the
//   wrapper's rule by the width); a step reads row s of W words and reduces
//   it: the max (probe.py:160) or column 0 (probe6.py:120 k_row), then
//   % mod.  In the max form lane g of a group reads words g, g + G, ... as
//   16-byte words where the row is 16-byte aligned (W % 4 == 0 and the
//   table's base aligned), else as 4-byte words, issues all its loads of a
//   batch (up to 16 words) before it uses any, keeps its own max, and the
//   group reduces with xor shuffles; the column-0 form is one lane and one
//   load a step.  The first design ran a warp a chain, 28 of its lanes
//   loading one 4-byte word each, so the card held 64 warps x 132 SMs =
//   8,448 chains at once (13% of the sweep's 65,536, in 7.76 waves); a
//   group of G lanes holds 270,336 / G, every chain of the sweep for G <= 4.
// * onehot_mma: g = onehot(idx[:, 0]) (B x T) @ tab (T x ncols), then
//   idx <- (idx + int(g)) & (T-1) (probe.py:192), on the tensor cores with
//   wgmma (sm_90a), fp16 x fp16 -> f32, dense over all T / 16 k-tiles as
//   the MXU is.  Integers below 2048 are exact in fp16, and each output sums
//   one non-zero product, so the product is exact.  A block is W warpgroups
//   of 64 rows over a slab of 16 columns (onehot_slab: W = 2 wherever there
//   are two k-tiles to split, else 1), so the timed shape, 1,024 rows x 128
//   columns, makes 128 blocks and every SM is busy.  It stages its slab of
//   the [ncols][T] fp16 table once, K-major in 8 x 8 core matrices without
//   swizzle (the layout its wgmma descriptor names), and the table's column
//   0 as T words.  A, the one-hot, is built in registers in the m16n8k16
//   A-fragment layout that wgmma takes from registers: only the k-tile that
//   holds a row's one is not zero, so a register is a compare and a select.
//   A warpgroup's k-tiles go in groups of 16 (or one at a time where it has
//   fewer than 16), and each group is waited for (wait_group 0) before the
//   next group's A registers are built: ptxas serializes every wgmma whose
//   A registers may be written while it runs (C7513).  Each block
//   advances its rows' column-0 chain from the staged column 0, one shared
//   load a row a step, so no block computes column 0's tile only to drive
//   the one-hot; the block that owns column 0 computes that column by the
//   product, and the card check holds the two equal.
// * gather2d: on an (8, 128) table, one warp a row of 128 indices, four a
//   lane (gather2d.cuh): the sublane gather out = tab[idx & 7, j] once
//   (probe2.py:56) or chained with s <- (tab[s & 7, j] + s) & 7
//   (probe6.py:162), and the sublane-then-lane gather
//   idx <- (idx + tab[sub[i, L], L] [+ r]) & mask, L = idx[i, j] & 127,
//   sub = (idx >> 7) & 7, whose exchange never leaves row i: each lane
//   computes the sublane gather for its own columns and the row's values
//   cross the warp, with no block barrier in the loop (probe2.py:86 on the
//   first tile only, probe3.py:142 on every tile).  The first design ran a
//   block of 1,024 threads a tile with two block barriers a step.
// * row_select: B chains over a table [S][A] of int32 or uint32 words; step r
//   reads row s whole and makes v, the chosen column cols[r % R][b] or the
//   row's 32-bit sum, then s = (v [+ r]) mod `mod` with the JAX operators'
//   semantics (floor modulo of the int32 value for an int32 table, unsigned
//   for a uint32 one): the chained row step of probe4.py:41 (fori_loop;
//   onehot, take and the sum control), probe5.py:56 (onehot and logtree,
//   both row[c] after a whole-row gather) and probe6.py:65 / :97 (lax.scan,
//   the row-width probes).  The question is what a whole row costs as it
//   widens, so every word of the row is loaded (volatile loads, none sunk
//   under the select) on row_chain's lane group, row_group(A) lanes a chain
//   with 16-byte loads where the row is 16-byte aligned and as many batches
//   as the row needs (32 passes of 8 lanes at 1,024 words, 2 batches of 16);
//   the chosen column comes from the lane that loaded it by one shuffle, the
//   sum by xor shuffles.  Bound: the step's latency, a row's loads plus the
//   shuffle and the modulo, times reps and the waves of chains.
// * window_chain: one chain a window from s = 0 over all the window's
//   classes, s <- tab[s * stride + c] (uint32 table; flat, a 32-bit index
//   clamped to the table, or by rows, the row and the column each clamped,
//   as XLA clamps the two gathers), the int32 sum of the final states:
//   probe7.py:152 (part_b, flat table[s*AP+c] and 2-D table[s, c], the same
//   load on this card but for the clamp) and
//   :183 (part_c), lax.scan.  The hashed tables do not synchronize, so only
//   a serial walk a window gives the JAX answer: a thread a window (8,192
//   chains at the probe's shape, 64 a block).  Where its row is 16-byte
//   aligned (the probe's 524 int32 classes are), each warp stages its 32
//   windows' classes in shared memory in tiles of 256 bytes of a row, two
//   buffers, copied by cp.async while the walk runs, and a step's only global load is
//   the table's (window_chain.cuh); else the first design's direct loads,
//   4-byte words of the row where it is 4-byte aligned, else one load a
//   class.  Bound: the latency of a dependent load from the table's
//   placement, L1, L2 or device memory, 524 a chain.
//
// What bounds them on the H100.  Each chain is a run of dependent loads:
// the time of a step is the latency of the placement (a shuffle, a shared
// load, an L1 / L2 / device-memory load), and a call takes at least
// reps x that latency x the waves its chains need; the bytes are a few
// words per chain, except where a table past the 50 MB L2 sends every
// step's sectors to device memory.  With every chain of the sweep in flight
// a step costs more than its idle latency: the shuffles of the old register
// form and the bank conflicts of one shared copy queued behind each other,
// and in global memory the card's rate of random 32-byte requests (the
// independent-address arm of bench/scan_variants.py chain_ab) bounds a call
// beside the latency.  That is the measurement: the lookup rate of each
// placement at each table size, for a chain that keeps the card full; a
// scan kernel's lane adds its class loads and its output to the same
// dependent load a character.  onehot_mma is bound by its tensor-core
// operations (2 * B * T * ncols per step) and by building its one-hot in
// registers, gather2d by the latency of its step (its latency floor).
// Indices are clamped (load ops) or masked (add ops) to the table, as XLA
// clamps a gather, so no input reads out of bounds.

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "gather2d.cuh"
#include "window_chain.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxShared = 232448;  // 227 KB a block can use on sm_90

enum Op { kAdd = 0, kAddR = 1, kLoad = 2, kLoadMod = 3 };
// kSharedOne: the shared placement where one copy fits (chosen at launch).
enum Placement { kShfl = 0, kShared = 1, kGlobal = 2, kSharedOne = 3 };

// A block-wide sum into one 32-bit word (wraps as an int32 sum does),
// through 32 words of the block's shared memory.
__device__ __forceinline__ void block_sum(uint32_t v, uint32_t* out, uint32_t* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    v = lane < warps ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) atomicAdd(out, v);
  }
}

// The copies of the table that the shared placement stages: the largest
// power of two up to 32 whose copies fit (kernels/probes.py shared_copies).
__host__ __device__ __forceinline__ uint32_t shared_copies(uint32_t T) {
  uint32_t r = 32u;
  while (r > 1u && static_cast<uint64_t>(r) * 4u * T > static_cast<uint64_t>(kMaxShared)) r >>= 1;
  return r;
}

// The part of an entry v that steers a chain: the next address, or (the add
// ops) what the masked sum needs of v.  Below T, so below 128 where the
// table lies in registers.
template <int kOp>
__device__ __forceinline__ uint32_t steer(uint32_t v, uint32_t last, uint32_t mod) {
  return kOp <= kAddR ? (v & last) : kOp == kLoad ? min(v, last) : v % mod;
}

// Entry x < 128 of the steering table from the warp's registers: lane l
// holds entries l, l + 32, l + 64, l + 96 as bytes 0-3 of `packed`.  The
// shuffle reads lane x mod 32; the byte is x / 32.
__device__ __forceinline__ uint32_t byte_lookup(uint32_t packed, uint32_t x) {
  const uint32_t w = __shfl_sync(0xffffffffu, packed, static_cast<int>(x));
  return __byte_perm(w, 0u, 0x4440u | (x >> 5));
}

template <int kOp>
__device__ __forceinline__ uint32_t advance(uint32_t i, uint32_t v, int r, uint32_t last,
                                            uint32_t mod) {
  if (kOp == kAdd) return (i + v) & last;
  if (kOp == kAddR) return (i + v + static_cast<uint32_t>(r)) & last;
  if (kOp == kLoad) return v;
  return v % mod;
}

template <int kOp, int kPlace>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const uint32_t* __restrict__ tab, uint32_t T, const uint32_t* __restrict__ idx,
                 int64_t n, int reps, uint32_t mod, int sum_out, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t staged[];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const uint32_t last = T - 1u;  // the mask of the add ops (T a power of two)
  const uint32_t lane = threadIdx.x & 31u;
  // Every thread runs the loop (the shuffles need the whole warp); threads
  // past n carry a dummy chain and write nothing.
  uint32_t i = c < n ? idx[c] : 0u;
  // The load op returns its last step's full value: in registers and shared
  // memory the steps before it run on the clamped entries, the last one
  // reads the table.
  const int steered = kOp == kLoad && reps > 0 ? reps - 1 : reps;
  if (kPlace == kShfl) {
    uint32_t packed = 0u;
#pragma unroll
    for (uint32_t j = 0; j < 4u; ++j) {
      const uint32_t e = lane + 32u * j;
      packed |= (e < T ? steer<kOp>(tab[e], last, mod) : 0u) << (8u * j);
    }
    // After the start's own clamp or mask, every value a step makes is an
    // address below T.
    if (reps > 0) i = kOp <= kAddR ? (i & last) : min(i, last);
    for (int r = 0; r < steered; ++r) i = advance<kOp>(i, byte_lookup(packed, i), r, last, mod);
    if (kOp == kLoad && reps > 0) i = __ldg(tab + i);
  } else if (kPlace == kSharedOne) {
    // One copy (T > 29,056): the entries as they are and the first design's
    // step, whose bank conflicts bound it; a chase of offsets would gain
    // nothing and add the load op's last read of the table.
    for (uint32_t w = threadIdx.x; w < T; w += kThreads) staged[w] = tab[w];
    __syncthreads();
    for (int r = 0; r < reps; ++r) {
      const uint32_t a = kOp <= kAddR ? (i & last) : min(i, last);
      i = advance<kOp>(i, staged[a], r, last, mod);
    }
  } else if (kPlace == kShared) {
    // R interleaved copies, word x R + (lane mod R) for entry x, each
    // holding the entry's steering value scaled to a byte offset: the load
    // ops the offset of the next word this lane reads (so a step is one
    // dependent load), the add ops the scaled v & (T - 1).
    const uint32_t copies = shared_copies(T);
    const uint32_t shift = __ffs(copies) - 1, s2 = shift + 2;
    const uint32_t mine = (lane & (copies - 1u)) << 2;
    auto word = [&](uint32_t w) {  // word w of the staged copies
      const uint32_t v = steer<kOp>(tab[w >> shift], last, mod) << s2;
      return kOp <= kAddR ? v : v | ((w & (copies - 1u)) << 2);
    };
    if (copies >= 4u) {  // 16-byte stores
      uint4* staged4 = reinterpret_cast<uint4*>(staged);
      for (uint32_t w = threadIdx.x; w < (T << shift) >> 2; w += kThreads) {
        staged4[w] = make_uint4(word(4 * w), word(4 * w + 1), word(4 * w + 2), word(4 * w + 3));
      }
    } else {
      for (uint32_t w = threadIdx.x; w < T << shift; w += kThreads) staged[w] = word(w);
    }
    __syncthreads();
    if (reps > 0) {
      const char* base = reinterpret_cast<const char*>(staged);
      const uint32_t span = last << s2;  // the add ops' mask, scaled
      uint32_t at = ((kOp <= kAddR ? (i & last) : min(i, last)) << s2) | mine;
      for (int r = 0; r < steered; ++r) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(base + at);
        if (kOp == kAdd) {
          at = ((at + v) & span) | mine;
        } else if (kOp == kAddR) {
          at = ((at + v + (static_cast<uint32_t>(r) << s2)) & span) | mine;
        } else {
          at = v;
        }
      }
      i = at >> s2;
      if (kOp == kLoad) i = __ldg(tab + i);
    }
  } else {
    for (int r = 0; r < reps; ++r) {
      const uint32_t a = kOp <= kAddR ? (i & last) : min(i, last);
      i = advance<kOp>(i, __ldg(tab + a), r, last, mod);
    }
  }
  if (sum_out) {
    // The sum's 32 words reuse the staged table once every step has read it
    // (no static shared memory: the copies may take all 227 KB).
    if (kPlace == kShared || kPlace == kSharedOne) __syncthreads();
    block_sum(c < n ? i : 0u, out, staged);
  } else if (c < n) {
    out[c] = i;
  }
}

template <int kOp, int kPlace>
cudaError_t launch_chain(const uint32_t* tab, uint32_t T, const uint32_t* idx, int64_t n, int reps,
                         uint32_t mod, int sum_out, uint32_t* out, cudaStream_t st) {
  size_t smem = sum_out ? 128u : 0u;  // the block sum's 32 words
  if (kPlace == kShared || kPlace == kSharedOne) {
    smem = static_cast<size_t>(T) * 4u * shared_copies(T);  // at least 128 B
    cudaError_t err = cudaFuncSetAttribute(chain_kernel<kOp, kPlace>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  chain_kernel<kOp, kPlace><<<grid, kThreads, smem, st>>>(tab, T, idx, n, reps, mod, sum_out, out);
  return cudaGetLastError();
}

template <int kOp>
cudaError_t launch_chain_op(int placement, const uint32_t* tab, uint32_t T, const uint32_t* idx,
                            int64_t n, int reps, uint32_t mod, int sum_out, uint32_t* out,
                            cudaStream_t st) {
  switch (placement) {
    case kShfl: return launch_chain<kOp, kShfl>(tab, T, idx, n, reps, mod, sum_out, out, st);
    case kShared:
      return shared_copies(T) == 1u
                 ? launch_chain<kOp, kSharedOne>(tab, T, idx, n, reps, mod, sum_out, out, st)
                 : launch_chain<kOp, kShared>(tab, T, idx, n, reps, mod, sum_out, out, st);
    case kGlobal: return launch_chain<kOp, kGlobal>(tab, T, idx, n, reps, mod, sum_out, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- row_chain

constexpr int kRowThreads = 256;
constexpr int kRowMaxBatch = 16;  // words a lane holds before it reduces them (64 registers
                                  // of 16-byte words)

// The max of the words this lane reads of a row of `words` words (16-byte
// words where kVec, else 4-byte ones): words g, g + G, g + 2G, ... , kB of
// them loaded before any is used, then reduced as a tree.  Words past the
// row read as 0, which no max can lose to.
template <int G, int kB, bool kVec>
__device__ __forceinline__ uint32_t lane_max(const uint32_t* __restrict__ row, int words, int g) {
  uint32_t v = 0u;
  for (int base = g; base < words; base += G * kB) {
    uint32_t m[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int c = base + j * G;
      if (kVec) {
        const uint4 x = c < words ? __ldg(reinterpret_cast<const uint4*>(row) + c)
                                  : make_uint4(0u, 0u, 0u, 0u);
        m[j] = max(max(x.x, x.y), max(x.z, x.w));
      } else {
        m[j] = c < words ? __ldg(row + c) : 0u;
      }
    }
#pragma unroll
    for (int step = 1; step < kB; step <<= 1) {
#pragma unroll
      for (int j = 0; j + step < kB; j += 2 * step) m[j] = max(m[j], m[j + step]);
    }
    v = max(v, m[0]);
  }
  return v;
}

// Chain i on lanes [i G, (i + 1) G) of the grid: each step reads row
// min(s, rows - 1) and reduces it (kMax: the max of its words, each lane its
// own words and then the group by xor shuffles within its G lanes; else
// column 0, G = 1), then takes it modulo mod.
template <int G, int kB, bool kVec, bool kMax>
__global__ void __launch_bounds__(kRowThreads)
    row_kernel(const uint32_t* __restrict__ tab, int64_t rows, int width,
               const uint32_t* __restrict__ s0, int64_t n, int reps, uint32_t mod,
               uint32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  const int64_t chain = t / G;
  if (chain >= n) return;  // a whole group leaves together
  const int g = static_cast<int>(t % G);
  const int lane = threadIdx.x & 31;
  const uint32_t group_mask = ((1u << G) - 1u) << (lane & ~(G - 1));  // G <= 8
  const int words = kVec ? width >> 2 : width;
  const uint64_t last = static_cast<uint64_t>(rows) - 1u;
  uint32_t s = s0[chain];
  for (int r = 0; r < reps; ++r) {
    const uint32_t* row = tab + min(static_cast<uint64_t>(s), last) * width;
    uint32_t v;
    if (kMax) {
      v = lane_max<G, kB, kVec>(row, words, g);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        v = max(v, __shfl_xor_sync(group_mask, v, off, G));
    } else {
      v = __ldg(row);
    }
    s = v % mod;
  }
  if (g == 0) out[chain] = s;
}

template <int G, int kB, bool kVec>
cudaError_t launch_rows_b(const uint32_t* t, int64_t rows, int width, const uint32_t* s, int64_t n,
                          int reps, uint32_t m, uint32_t* o, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((n * G + kRowThreads - 1) / kRowThreads);
  row_kernel<G, kB, kVec, true><<<grid, kRowThreads, 0, st>>>(t, rows, width, s, n, reps, m, o);
  return cudaGetLastError();
}

// kB: the words a lane reads of a row, rounded up to a power of two, at most
// kRowMaxBatch (a wider row takes more than one batch).
template <int G, bool kVec>
cudaError_t launch_rows_g(int per_lane, const uint32_t* t, int64_t rows, int width,
                          const uint32_t* s, int64_t n, int reps, uint32_t m, uint32_t* o,
                          cudaStream_t st) {
  if (per_lane <= 1) return launch_rows_b<G, 1, kVec>(t, rows, width, s, n, reps, m, o, st);
  if (per_lane <= 2) return launch_rows_b<G, 2, kVec>(t, rows, width, s, n, reps, m, o, st);
  if (per_lane <= 4) return launch_rows_b<G, 4, kVec>(t, rows, width, s, n, reps, m, o, st);
  if (per_lane <= 8) return launch_rows_b<G, 8, kVec>(t, rows, width, s, n, reps, m, o, st);
  return launch_rows_b<G, kRowMaxBatch, kVec>(t, rows, width, s, n, reps, m, o, st);
}

template <bool kVec>
cudaError_t launch_rows(int group, const uint32_t* t, int64_t rows, int width, const uint32_t* s,
                        int64_t n, int reps, uint32_t m, uint32_t* o, cudaStream_t st) {
  const int words = kVec ? width >> 2 : width;
  const int per_lane = (words + group - 1) / group;
  switch (group) {
    case 1: return launch_rows_g<1, kVec>(per_lane, t, rows, width, s, n, reps, m, o, st);
    case 2: return launch_rows_g<2, kVec>(per_lane, t, rows, width, s, n, reps, m, o, st);
    case 4: return launch_rows_g<4, kVec>(per_lane, t, rows, width, s, n, reps, m, o, st);
    case 8: return launch_rows_g<8, kVec>(per_lane, t, rows, width, s, n, reps, m, o, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ row_select

// Loads the select form keeps although it uses one word of them: volatile,
// so that no load is sunk under the compare that picks the chosen word.
__device__ __forceinline__ uint4 ld_row4(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_row(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// What lane g of a group makes of a row of `words` words (16-byte words where
// kVec): words g, g + G, ... , kB of them loaded before any is used.  kSum:
// their 32-bit sum (wrapping); else the word `cw` if this lane reads it (the
// chosen column's component `part` of it where kVec), else 0.
template <int G, int kB, bool kVec, bool kSum>
__device__ __forceinline__ uint32_t lane_row(const uint32_t* __restrict__ row, int words, int g,
                                             int cw, uint32_t part) {
  uint32_t acc = 0u;
  uint4 keep = make_uint4(0u, 0u, 0u, 0u);
  for (int base = g; base < words; base += G * kB) {
    uint4 m[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int w = base + j * G;
      if (kVec) {
        m[j] = w < words ? ld_row4(row + 4 * w) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        m[j] = make_uint4(w < words ? ld_row(row + w) : 0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (kSum) {
        acc += m[j].x + m[j].y + m[j].z + m[j].w;
      } else if (base + j * G == cw) {
        keep = m[j];
      }
    }
  }
  if (kSum) return acc;
  if (!kVec) return keep.x;
  return part == 0u ? keep.x : part == 1u ? keep.y : part == 2u ? keep.z : keep.w;
}

// Chain i on lanes [i G, (i + 1) G): each step reads row min(s, rows - 1)
// whole and makes v, the chosen column cols[r % R][i] (clamped to the row,
// from the lane that read it by one shuffle) or the row's sum (the group's
// xor shuffles), then s = (v [+ r]) mod `mod`: floor modulo of the int32
// value for an int32 table (kSigned), unsigned modulo for a uint32 one.
template <int G, int kB, bool kVec, bool kSum>
__global__ void __launch_bounds__(kRowThreads)
    select_kernel(const uint32_t* __restrict__ tab, int64_t rows, int width,
                  const uint32_t* __restrict__ s0, const uint32_t* __restrict__ cols, int R,
                  int64_t n, int reps, uint32_t mod, int add_r, int is_signed,
                  uint32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  const int64_t chain = t / G;
  if (chain >= n) return;  // a whole group leaves together
  const int g = static_cast<int>(t % G);
  const int lane = threadIdx.x & 31;
  const uint32_t group_mask = ((1u << G) - 1u) << (lane & ~(G - 1));  // G <= 8
  const int words = kVec ? width >> 2 : width;
  const uint64_t last = static_cast<uint64_t>(rows) - 1u;
  const uint32_t last_col = static_cast<uint32_t>(width) - 1u;
  uint32_t s = s0[chain];
  int rr = 0;  // r % R
  for (int r = 0; r < reps; ++r) {
    const uint32_t* row = tab + min(static_cast<uint64_t>(s), last) * width;
    uint32_t v;
    if (kSum) {
      v = lane_row<G, kB, kVec, true>(row, words, g, 0, 0u);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(group_mask, v, off, G);
    } else {
      const uint32_t c = min(__ldg(cols + static_cast<int64_t>(rr) * n + chain), last_col);
      const int cw = static_cast<int>(kVec ? c >> 2 : c);
      v = lane_row<G, kB, kVec, false>(row, words, g, cw, c & 3u);
      if (G > 1) v = __shfl_sync(group_mask, v, cw % G, G);
      if (++rr == R) rr = 0;
    }
    const uint32_t x = v + (add_r ? static_cast<uint32_t>(r) : 0u);
    if (is_signed) {
      const int32_t m = static_cast<int32_t>(x) % static_cast<int32_t>(mod);
      s = static_cast<uint32_t>(m < 0 ? m + static_cast<int32_t>(mod) : m);
    } else {
      s = x % mod;
    }
  }
  if (g == 0) out[chain] = s;
}

struct SelectArgs {
  const uint32_t* tab;
  int64_t rows;
  int width;
  const uint32_t* s0;
  const uint32_t* cols;
  int R;
  int64_t n;
  int reps;
  uint32_t mod;
  int add_r;
  int is_signed;
  uint32_t* out;
};

template <int G, int kB, bool kVec, bool kSum>
cudaError_t launch_select_b(const SelectArgs& a, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((a.n * G + kRowThreads - 1) / kRowThreads);
  select_kernel<G, kB, kVec, kSum><<<grid, kRowThreads, 0, st>>>(
      a.tab, a.rows, a.width, a.s0, a.cols, a.R, a.n, a.reps, a.mod, a.add_r, a.is_signed, a.out);
  return cudaGetLastError();
}

// kB as in launch_rows_g: a lane's words of a row, rounded up to a power of
// two, at most kRowMaxBatch (a wider row takes more than one batch).
template <int G, bool kVec, bool kSum>
cudaError_t launch_select_g(int per_lane, const SelectArgs& a, cudaStream_t st) {
  if (per_lane <= 1) return launch_select_b<G, 1, kVec, kSum>(a, st);
  if (per_lane <= 2) return launch_select_b<G, 2, kVec, kSum>(a, st);
  if (per_lane <= 4) return launch_select_b<G, 4, kVec, kSum>(a, st);
  if (per_lane <= 8) return launch_select_b<G, 8, kVec, kSum>(a, st);
  return launch_select_b<G, kRowMaxBatch, kVec, kSum>(a, st);
}

template <bool kVec, bool kSum>
cudaError_t launch_select(int group, const SelectArgs& a, cudaStream_t st) {
  const int words = kVec ? a.width >> 2 : a.width;
  const int per_lane = (words + group - 1) / group;
  switch (group) {
    case 1: return launch_select_g<1, kVec, kSum>(per_lane, a, st);
    case 2: return launch_select_g<2, kVec, kSum>(per_lane, a, st);
    case 4: return launch_select_g<4, kVec, kSum>(per_lane, a, st);
    case 8: return launch_select_g<8, kVec, kSum>(per_lane, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------- window_chain

constexpr int kWinThreads = 64;  // the direct form: 8,192 windows in 128 blocks

// The direct form, for rows that are not 16-byte aligned (the first
// design): one chain a window, s = 0 then s <- tab[chain_at(s, c)] over
// every class of the row; the block adds its chains' final states into out.
// kCB: bytes a class (1, 2 or 4).  Where `words` (the row's bytes a
// multiple of 4 and the base 4-byte aligned), the classes come as 4-byte
// words of the row, the next word loaded before the classes of this one are
// walked; else one load a class.
template <int kCB, bool kRows>
__global__ void __launch_bounds__(kWinThreads)
    window_kernel(const uint32_t* __restrict__ tab, uint32_t last, uint32_t rows_last,
                  uint32_t stride, const uint8_t* __restrict__ windows, int width, int64_t n,
                  int words, uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[32];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWinThreads + threadIdx.x;
  uint32_t s = 0u;
  if (b < n) {
    const uint8_t* row = windows + b * static_cast<int64_t>(width) * kCB;
    if (words) {
      constexpr int kPer = 4 / kCB;  // classes a word
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(row);
      const int nw = width / kPer;
      uint32_t next = nw > 0 ? __ldg(wr) : 0u;
      for (int k = 0; k < nw; ++k) {
        const uint32_t word = next;
        if (k + 1 < nw) next = __ldg(wr + k + 1);
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          uint32_t c;
          if constexpr (kCB == 4) {
            c = word;
          } else {
            c = (word >> (8 * kCB * q)) & ((1u << (8 * kCB)) - 1u);
          }
          s = __ldg(tab + wc::chain_at<kRows>(s, c, stride, last, rows_last));
        }
      }
    } else {
      for (int t = 0; t < width; ++t) {
        uint32_t c;
        if constexpr (kCB == 1) {
          c = __ldg(row + t);
        } else if constexpr (kCB == 2) {
          c = __ldg(reinterpret_cast<const uint16_t*>(row) + t);
        } else {
          c = __ldg(reinterpret_cast<const uint32_t*>(row) + t);
        }
        s = __ldg(tab + wc::chain_at<kRows>(s, c, stride, last, rows_last));
      }
    }
  }
  block_sum(s, out, warp_sums);
}

// The staged form (csrc/window_chain.cuh) where the row is 16-byte aligned,
// else the direct form.
template <int kCB, bool kRows>
cudaError_t launch_window(const uint32_t* tab, uint32_t last, uint32_t rows_last, uint32_t stride,
                          const uint8_t* w, int width, int64_t n, uint32_t* out, cudaStream_t st) {
  const int64_t row_bytes = static_cast<int64_t>(width) * kCB;
  if (row_bytes % wc::kVec == 0 && reinterpret_cast<uintptr_t>(w) % wc::kVec == 0) {
    return wc::launch_staged<kCB, kRows>(tab, last, rows_last, stride, w, row_bytes, n, out, st);
  }
  const int words = row_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const unsigned grid = static_cast<unsigned>((n + kWinThreads - 1) / kWinThreads);
  window_kernel<kCB, kRows><<<grid, kWinThreads, 0, st>>>(tab, last, rows_last, stride, w, width,
                                                          n, words, out);
  return cudaGetLastError();
}

template <bool kRows>
cudaError_t launch_window_cb(int window_bytes, const uint32_t* tab, uint32_t last,
                             uint32_t rows_last, uint32_t stride, const uint8_t* w, int width,
                             int64_t n, uint32_t* out, cudaStream_t st) {
  switch (window_bytes) {
    case 1: return launch_window<1, kRows>(tab, last, rows_last, stride, w, width, n, out, st);
    case 2: return launch_window<2, kRows>(tab, last, rows_last, stride, w, width, n, out, st);
    case 4: return launch_window<4, kRows>(tab, last, rows_last, stride, w, width, n, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ onehot_mma

constexpr int kSlab = 16;  // columns a block: (B / 64) x (ncols / 16) blocks, 128 at P4

// The warpgroups a block (kernels/probes.py onehot_slab): two splitting the
// k-tiles wherever there are two.
int onehot_warpgroups(int T) { return T >= 32 ? 2 : 1; }

// The shared memory a block of onehot_kernel<*, w> takes: its slab of kSlab
// columns, fp16; column 0 of the table as T words; and with two
// warpgroups, two buffers of the second one's sums.
size_t onehot_shared(int T, int w) {
  return static_cast<size_t>(T) * (2u * kSlab + 4u) + (w == 2 ? 512u * kSlab : 0u);
}

// A wgmma descriptor of a K-major operand in 8 x 8 core matrices of 16-bit
// elements without swizzle: `lbo` bytes between core matrices along K,
// `sbo` bytes between them along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);  // layout type 0: no swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a register's use across a wgmma wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (+)= A (registers, m16n8k16 A-fragment layout per warp) x B (shared, by
// descriptor), m64 x n16 x k16, fp16 in, f32 out; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Where a row's one lies for this thread (lane = 4 g + t4): the k-tile that
// holds column s (none when s >= T) and the fp16 pair registers of that
// tile, lo for columns 2 t4, 2 t4 + 1 and hi for 2 t4 + 8, 2 t4 + 9 (the
// lower column in the low half).
struct OneHotRow {
  uint32_t tile, lo, hi;
};

__device__ __forceinline__ OneHotRow onehot_row(uint32_t s, uint32_t T, uint32_t t4) {
  const uint32_t k = s & 15u;
  const uint32_t one = ((k >> 1) & 3u) == t4 ? ((k & 1u) ? 0x3C000000u : 0x3C00u) : 0u;
  return {s < T ? s >> 4 : 0xFFFFFFFFu, k < 8u ? one : 0u, k < 8u ? 0u : one};
}

// Builds the A fragments of k-tiles base .. base + kG - 1 and runs their
// wgmmas as one group to its end, so that no A register is written while a
// wgmma that reads it is in flight (ptxas serializes every wgmma otherwise).
template <int kG>
__device__ __forceinline__ void onehot_group(float (&acc)[8], const OneHotRow& ra,
                                             const OneHotRow& rb, int base, bool first,
                                             uint32_t lbo, uint32_t sbo, const __half* slab) {
  uint32_t a[kG][4];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const uint32_t kt = static_cast<uint32_t>(base + j);
    a[j][0] = kt == ra.tile ? ra.lo : 0u;  // row g, k 2 t4 ..
    a[j][1] = kt == rb.tile ? rb.lo : 0u;  // row g + 8
    a[j][2] = kt == ra.tile ? ra.hi : 0u;  // row g, k 2 t4 + 8 ..
    a[j][3] = kt == rb.tile ? rb.hi : 0u;  // row g + 8
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(a[j][e]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    // k-tile kt: the two core matrices along K at 256 kt bytes of each
    // 8-column group of the slab
    wgmma_rs(acc, a[j], smem_desc(slab + (base + j) * 128, lbo, sbo), first && j == 0 ? 0 : 1);
  }
  wgmma_commit();
  wgmma_wait_all();
}

// tabT: the fp16 table transposed, [ncols][T]; idx, out: uint32[B][ncols].
// Grid (ceil(B / 64), ncols / kSlab), 128 kW threads: kW warpgroups over the
// same 64 rows, warpgroup w over k-tiles [w, w + 1) T / (16 kW), the second
// one's sums handed to the first through shared memory (two buffers, one
// barrier a step).  Accumulator layout (warp q of a warpgroup, lane = 4 g +
// t4): element 4 j + e is row 16 q + g + 8 (e >> 1), column 8 j + 2 t4 +
// (e & 1).
template <int kG, int kW>
__global__ void __launch_bounds__(128 * kW)
    onehot_kernel(const __half* __restrict__ tabT, int T, int ncols,
                  const uint32_t* __restrict__ idx, int B, int reps, int aligned,
                  uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char onehot_smem[];
  __half* slab = reinterpret_cast<__half*>(onehot_smem);  // kSlab x T, core matrices
  uint32_t* col0 = reinterpret_cast<uint32_t*>(onehot_smem + static_cast<size_t>(T) * kSlab * 2);
  float* partial = reinterpret_cast<float*>(col0 + T);  // [2][kSlab / 2][128] where kW == 2
  const int c0 = blockIdx.y * kSlab;
  // 16-byte chunk q of the slab: rows n = 8 ng + (q & 7) of the slab, k =
  // 8 kb .. 8 kb + 7, q = (ng (T / 8) + kb) 8 + (q & 7): consecutive threads
  // store consecutive chunks.  Core matrix (ng, kb) is 128 contiguous bytes;
  // along K they lie 128 bytes apart (lbo), along N 16 T bytes (sbo).
  const int kb_count = T >> 3;
  for (int q = threadIdx.x; q < kSlab * kb_count; q += blockDim.x) {
    const int n = (q / (8 * kb_count)) * 8 + (q & 7);
    const int kb = (q >> 3) % kb_count;
    const __half* src = tabT + static_cast<int64_t>(c0 + n) * T + kb * 8;
    uint4 v;
    if (aligned) {
      v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = s16[2 * e] | (static_cast<uint32_t>(s16[2 * e + 1]) << 16);
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    reinterpret_cast<uint4*>(slab)[q] = v;
  }
  for (int k = threadIdx.x; k < T; k += blockDim.x) {
    col0[k] = static_cast<uint32_t>(__half2float(tabT[k]));
  }
  // the slab is read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int q = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const uint32_t t4 = lane & 3;
  const int row_a = blockIdx.x * 64 + q * 16 + g;
  const int row_b = row_a + 8;
  const uint32_t uT = static_cast<uint32_t>(T);
  const uint32_t mask = uT - 1u;
  constexpr int kChunks = kSlab / 8;
  uint32_t v[kChunks][4];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      v[j][e] = row < B ? idx[static_cast<int64_t>(row) * ncols + c0 + 8 * j + 2 * t4 + (e & 1)]
                        : 0u;
    }
  }
  // Column 0 of the thread's two rows; a padding row drives nothing.
  uint32_t sa = row_a < B ? idx[static_cast<int64_t>(row_a) * ncols] : uT;
  uint32_t sb = row_b < B ? idx[static_cast<int64_t>(row_b) * ncols] : uT;
  const uint32_t lbo = 128u;
  const uint32_t sbo = 16u * uT;
  const int per = (T >> 4) / kW;  // k-tiles a warpgroup
  const int k0 = wg * per;
  for (int r = 0; r < reps; ++r) {
    const OneHotRow ra = onehot_row(sa, uT, t4), rb = onehot_row(sb, uT, t4);
    float acc[kSlab / 2];
#pragma unroll
    for (int e = 0; e < kSlab / 2; ++e) acc[e] = 0.f;
    for (int base = k0; base < k0 + per; base += kG) {
      onehot_group<kG>(acc, ra, rb, base, base == k0, lbo, sbo, slab);
    }
#pragma unroll
    for (int e = 0; e < kSlab / 2; ++e) fence_reg(acc[e]);
    if (kW == 2) {
      float* part = partial + (r & 1) * (kSlab / 2) * 128 + t;
      if (wg == 1) {
#pragma unroll
        for (int e = 0; e < kSlab / 2; ++e) part[e * 128] = acc[e];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < kSlab / 2; ++e) acc[e] += part[e * 128];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[j][e] = (v[j][e] + static_cast<uint32_t>(__float2int_rz(acc[4 * j + e]))) & mask;
      }
    }
    sa = (sa + (sa < uT ? col0[sa] : 0u)) & mask;
    sb = (sb + (sb < uT ? col0[sb] : 0u)) & mask;
  }
  if (wg != 0) return;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      if (row < B) out[static_cast<int64_t>(row) * ncols + c0 + 8 * j + 2 * t4 + (e & 1)] = v[j][e];
    }
  }
}

template <int kG, int kW>
cudaError_t launch_onehot(const __half* t, int T, int ncols, const uint32_t* idx, int B, int reps,
                          uint32_t* out, cudaStream_t st) {
  const size_t smem = onehot_shared(T, kW);
  cudaError_t err = cudaFuncSetAttribute(onehot_kernel<kG, kW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 63) / 64, ncols / kSlab);
  const int aligned = reinterpret_cast<uintptr_t>(t) % 16 == 0;
  onehot_kernel<kG, kW><<<grid, 128 * kW, smem, st>>>(t, T, ncols, idx, B, reps, aligned, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tab: uint32[T]; idx, out: uint32[n] (out: uint32[1], zeroed, with sum_out).
int chain_gather(const void* tab, int64_t T, const void* idx, int64_t n, int reps, int op,
                 int placement, int64_t mod, int sum_out, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || T > 0xffffffffLL || n < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (op <= kAddR && (T & (T - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (op == kLoadMod && (mod < 1 || mod > T)) return static_cast<int>(cudaErrorInvalidValue);
  if (placement == kShfl && T > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (placement == kShared && T * 4 > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* x = static_cast<const uint32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto tt = static_cast<uint32_t>(T);
  const auto m = static_cast<uint32_t>(mod);
  switch (op) {
    case kAdd: err = launch_chain_op<kAdd>(placement, t, tt, x, n, reps, m, sum_out, o, st); break;
    case kAddR: err = launch_chain_op<kAddR>(placement, t, tt, x, n, reps, m, sum_out, o, st); break;
    case kLoad: err = launch_chain_op<kLoad>(placement, t, tt, x, n, reps, m, sum_out, o, st); break;
    case kLoadMod:
      err = launch_chain_op<kLoadMod>(placement, t, tt, x, n, reps, m, sum_out, o, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// tab: uint32[rows][width]; s0, out: uint32[n]; reduce 0 = max, 1 = column 0;
// group: the lanes a chain of the max form, 1, 2, 4 or 8 (the column-0 form
// runs one lane a chain and takes group 1).
int row_chain(const void* tab, int64_t rows, int width, const void* s0, int64_t n, int reps,
              int reduce, int64_t mod, int group, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || width < 1 || n < 1 || reps < 0 || mod < 1 || mod > 0xffffffffLL ||
      (reduce == 1 && group != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* s = static_cast<const uint32_t*>(s0);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<uint32_t>(mod);
  if (reduce == 0) {
    const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
    err = vec ? launch_rows<true>(group, t, rows, width, s, n, reps, m, o, st)
              : launch_rows<false>(group, t, rows, width, s, n, reps, m, o, st);
  } else if (reduce == 1) {
    const unsigned grid = static_cast<unsigned>((n + kRowThreads - 1) / kRowThreads);
    row_kernel<1, 1, false, false><<<grid, kRowThreads, 0, st>>>(t, rows, width, s, n, reps, m, o);
    err = cudaGetLastError();
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// tab: uint32[rows][width] (int32 words where is_signed); s0, out: uint32[n];
// cols: uint32[R][n] (read only by how 0 = select; how 1 = sum); group: the
// lanes a chain, 1, 2, 4 or 8.
int row_select(const void* tab, int64_t rows, int width, const void* s0, const void* cols, int R,
               int64_t n, int reps, int how, int64_t mod, int add_r, int is_signed, int group,
               void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mod_max = is_signed ? 0x7fffffffLL : 0xffffffffLL;
  if (rows < 1 || width < 1 || n < 1 || reps < 0 || R < 1 || mod < 1 || mod > mod_max ||
      (how != 0 && how != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelectArgs a{static_cast<const uint32_t*>(tab), rows, width,
                     static_cast<const uint32_t*>(s0), static_cast<const uint32_t*>(cols), R, n,
                     reps, static_cast<uint32_t>(mod), add_r, is_signed,
                     static_cast<uint32_t*>(out)};
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
  if (how == 1) {
    err = vec ? launch_select<true, true>(group, a, st) : launch_select<false, true>(group, a, st);
  } else {
    err = vec ? launch_select<true, false>(group, a, st)
              : launch_select<false, false>(group, a, st);
  }
  return static_cast<int>(err);
}

// tab: uint32[numel], read flat (rows 0) or as rows of `stride` words;
// windows: [n][width] classes of window_bytes (1, 2 or 4) bytes; out:
// uint32[1], zeroed: the int32 sum of the chains' final states.
int window_chain(const void* tab, int64_t numel, int64_t rows, int64_t stride, const void* windows,
                 int window_bytes, int64_t n, int width, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (numel < 1 || numel > 0xffffffffLL || stride < 1 || stride > 0xffffffffLL || n < 1 ||
      width < 0 || rows < 0 || (rows > 0 && rows * stride != numel)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* w = static_cast<const uint8_t*>(windows);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto last = static_cast<uint32_t>(numel - 1);
  const auto sd = static_cast<uint32_t>(stride);
  err = rows > 0 ? launch_window_cb<true>(window_bytes, t, last, static_cast<uint32_t>(rows - 1),
                                          sd, w, width, n, o, st)
                 : launch_window_cb<false>(window_bytes, t, last, 0u, sd, w, width, n, o, st);
  return static_cast<int>(err);
}

// tabT: fp16[ncols][T] (integers < 2048); idx, out: uint32[B][ncols].
int onehot_mma(const void* tabT, int T, int ncols, const void* idx, int B, int reps, void* out,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w = onehot_warpgroups(T);
  if (T < 16 || (T & (T - 1)) != 0 || ncols < 32 || ncols % 32 != 0 || B < 1 || reps < 0 ||
      onehot_shared(T, w) > static_cast<size_t>(kMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const __half*>(tabT);
  const auto* x = static_cast<const uint32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // The group: a warpgroup's k-tiles (a power of two) 16 at a time where
  // there are 16 or more, else one at a time.
  if (w == 1) return static_cast<int>(launch_onehot<1, 1>(t, T, ncols, x, B, reps, o, st));
  return static_cast<int>(T / 32 >= 16 ? launch_onehot<16, 2>(t, T, ncols, x, B, reps, o, st)
                                       : launch_onehot<1, 2>(t, T, ncols, x, B, reps, o, st));
}

// tab: uint32[8][128]; idx: uint32[rows][128] (rows a multiple of 8); out
// like idx, or uint32[1] (zeroed) with sum_out.  The launch, `blocks` blocks
// of `warps` rows, is kernels/probes.gather2d_shape's.
int gather2d(const void* tab, const void* idx, int64_t rows, int reps, int64_t mask, int mode,
             int sum_out, int warps, int64_t blocks, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mask < 0 || mask > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(g2::launch(
      static_cast<const uint32_t*>(tab), static_cast<const uint32_t*>(idx), rows, reps,
      static_cast<uint32_t>(mask), mode, sum_out, warps, blocks, static_cast<uint32_t*>(out),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
