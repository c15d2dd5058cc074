// Lookup-primitive probes for Hopper (sm_90a): four kernels behind a plain C
// interface loaded with ctypes (ahocorasick_tpu_torch/kernels/build.py builds
// it, kernels/probes.py binds it, ahocorasick_tpu_torch/probes/ drives it).
//
// What they replace.  The v5e micro-benchmarks of tools/probes/, thirteen
// pl.pallas_call sites that time one transition primitive each: a chained
// table lookup per step, repeated so that nothing can be hoisted.  They
// compute what the Pallas bodies compute; VMEM, lane permutes and the MXU do
// not carry over, so the placements below are this card's own.
//
// * chain_gather: independent chains  i <- (i + tab[i & (T-1)] [+ r]) & (T-1),
//   i <- tab[i]  or  i <- tab[i] % mod  for `reps` steps, one thread per
//   chain (probe.py:70, :103, :129, :239; probe2.py:39; probe3.py:77, :105;
//   probe6.py:120 k_flat_elem / k_take).  The table lies where `placement`
//   says: in four registers per lane of each warp, read with four
//   __shfl_sync and a select (T <= 128: the warp form of the lane gather),
//   staged in dynamic shared memory (T * 4 B <= 227 KB), or read with __ldg
//   through L1 / L2 / device memory.  Out: the final chain values, or their
//   sum modulo 2^32 (probe3's (1, 1) SMEM scalar, an int32 sum).
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
//   mma.sync m16n8k16, fp16 x fp16 -> f32.  Integers below 2048 are exact
//   in fp16, and each output sums one non-zero product, so the product is
//   exact.  Each block stages a tile of 32 columns (and, unless it holds
//   them, columns 0-7, whose column 0 drives the one-hot) of the fp16 table
//   in shared memory; each warp keeps 16 rows of the chain in registers in
//   the accumulator's layout and shuffles column 0 to the lanes that build
//   the one-hot fragment.  Dense over all T / 16 k-tiles, as the MXU is.
// * gather2d: on an (8, 128) table in shared memory, one block of 1,024
//   threads per 8 x 128 tile of indices: the sublane gather
//   out = tab[idx & 7, j] once (probe2.py:56) or chained with
//   s <- (tab[s & 7, j] + s) & 7 (probe6.py:162), and the sublane-then-lane
//   gather  idx <- (idx + tab[sub[i, L], L] [+ r]) & mask,
//   L = idx[i, j] & 127, sub = (idx >> 7) & 7, which reads another thread's
//   index of the same row through shared memory with a __syncthreads per
//   step (probe2.py:86 on the first tile only, probe3.py:142 on every tile).
//
// What bounds them on the H100.  Each chain is a run of dependent loads:
// the time of a step is the latency of the placement (a shuffle, a shared
// load, an L1 / L2 / device-memory load), and a call takes at least
// reps x that latency x the waves its chains need; the bytes are a few
// words per chain, except where a table past the 50 MB L2 sends every
// step's sectors to device memory.  That is the measurement: the lookup
// rate of each placement at each table size, for a chain that keeps the
// card full; a scan kernel's lane adds its class loads and its output to
// the same dependent load a character.  onehot_mma is bound by its
// tensor-core operations (2 * B * T * ncols per step), gather2d by the two
// barriers per step.  Indices are clamped (load ops) or masked (add ops) to
// the table, as XLA clamps a gather, so no input reads out of bounds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxShared = 232448;  // 227 KB a block can use on sm_90

enum Op { kAdd = 0, kAddR = 1, kLoad = 2, kLoadMod = 3 };
enum Placement { kShfl = 0, kShared = 1, kGlobal = 2 };

// A block-wide sum into one 32-bit word (wraps as an int32 sum does).
__device__ __forceinline__ void block_sum(uint32_t v, uint32_t* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __shared__ uint32_t warp_sums[32];
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

// tab[x] for x < 128 from the warp's registers: lane l holds
// tab[l], tab[l + 32], tab[l + 64], tab[l + 96].
__device__ __forceinline__ uint32_t shfl_lookup(const uint32_t (&reg)[4], uint32_t x) {
  const int src = static_cast<int>(x & 31u);
  const uint32_t v0 = __shfl_sync(0xffffffffu, reg[0], src);
  const uint32_t v1 = __shfl_sync(0xffffffffu, reg[1], src);
  const uint32_t v2 = __shfl_sync(0xffffffffu, reg[2], src);
  const uint32_t v3 = __shfl_sync(0xffffffffu, reg[3], src);
  const uint32_t q = (x >> 5) & 3u;
  return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

template <int kOp, int kPlace>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const uint32_t* __restrict__ tab, uint32_t T, const uint32_t* __restrict__ idx,
                 int64_t n, int reps, uint32_t mod, int sum_out, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t staged[];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const uint32_t last = T - 1u;  // the mask of the add ops (T a power of two)
  uint32_t reg[4] = {0u, 0u, 0u, 0u};
  if (kPlace == kShared) {
    for (uint32_t j = threadIdx.x; j < T; j += kThreads) staged[j] = tab[j];
    __syncthreads();
  } else if (kPlace == kShfl) {
    const uint32_t lane = threadIdx.x & 31u;
    for (int j = 0; j < 4; ++j) {
      const uint32_t e = lane + 32u * j;
      reg[j] = e < T ? tab[e] : 0u;
    }
  }
  // Every thread runs the loop (the shuffles need the whole warp); threads
  // past n carry a dummy chain and write nothing.
  uint32_t i = c < n ? idx[c] : 0u;
  for (int r = 0; r < reps; ++r) {
    const uint32_t a = kOp <= kAddR ? (i & last) : min(i, last);
    uint32_t v;
    if (kPlace == kShfl) {
      v = shfl_lookup(reg, a);
    } else if (kPlace == kShared) {
      v = staged[a];
    } else {
      v = __ldg(tab + a);
    }
    if (kOp == kAdd) {
      i = (i + v) & last;
    } else if (kOp == kAddR) {
      i = (i + v + static_cast<uint32_t>(r)) & last;
    } else if (kOp == kLoad) {
      i = v;
    } else {
      i = v % mod;
    }
  }
  if (sum_out) {
    block_sum(c < n ? i : 0u, out);
  } else if (c < n) {
    out[c] = i;
  }
}

template <int kOp, int kPlace>
cudaError_t launch_chain(const uint32_t* tab, uint32_t T, const uint32_t* idx, int64_t n, int reps,
                         uint32_t mod, int sum_out, uint32_t* out, cudaStream_t st) {
  size_t smem = 0;
  if (kPlace == kShared) {
    smem = static_cast<size_t>(T) * 4u;
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
    case kShared: return launch_chain<kOp, kShared>(tab, T, idx, n, reps, mod, sum_out, out, st);
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

// ------------------------------------------------------------ onehot_mma

constexpr int kMmaWarps = 2;       // 16 rows of the chain each
constexpr int kBlockCols = 32;     // four n-tiles of 8 columns
constexpr int kMaxTiles = kBlockCols / 8 + 1;

// Two fp16 one-hot elements (columns k and k + 1 of a row whose one is at s)
// packed as the .f16x2 register of an A fragment: the lower column low.
__device__ __forceinline__ uint32_t onehot2(uint32_t s, uint32_t k) {
  return (s == k ? 0x3C00u : 0u) | (s == k + 1u ? 0x3C000000u : 0u);
}

__device__ __forceinline__ void mma16816(float (&acc)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// tabT: the fp16 table transposed, [ncols][T]; idx, out: uint32[B][ncols].
// Accumulator layout of m16n8k16 (lane = 4 g + t): element e of a tile is
// row g + 8 (e >> 1), column 2 t + (e & 1).
__global__ void __launch_bounds__(kMmaWarps * 32)
    onehot_kernel(const uint32_t* __restrict__ tabT, int T, int ncols,
                  const uint32_t* __restrict__ idx, int B, int reps, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t staged[];  // [tiles * 8][(T + 8) / 2] words
  const int c0 = blockIdx.y * kBlockCols;
  const int tiles = kBlockCols / 8 + (c0 != 0 ? 1 : 0);  // the last one: columns 0-7
  const int stride = (T + 8) / 2;  // padded: the 8 groups of a fragment load hit 32 banks
  auto column = [&](int lc) { return lc < kBlockCols ? c0 + lc : lc - kBlockCols; };
  for (int lc = 0; lc < tiles * 8; ++lc) {
    const uint32_t* src = tabT + static_cast<int64_t>(column(lc)) * (T / 2);
    for (int w = threadIdx.x; w < T / 2; w += blockDim.x) staged[lc * stride + w] = src[w];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = (blockIdx.x * kMmaWarps + warp) * 16;
  uint32_t v[kMaxTiles][4];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = column(t * 8 + 2 * t4 + (e & 1));
      v[t][e] = (t < tiles && row < B) ? idx[static_cast<int64_t>(row) * ncols + col] : 0u;
    }
  }
  const uint32_t mask = static_cast<uint32_t>(T) - 1u;
  for (int r = 0; r < reps; ++r) {
    // Column 0 of rows g and g + 8 lies with lane 4 g (t4 == 0), in tile 0
    // or in the extra tile (indexed statically, so v stays in registers).
    const uint32_t ca = c0 != 0 ? v[kMaxTiles - 1][0] : v[0][0];
    const uint32_t cb = c0 != 0 ? v[kMaxTiles - 1][2] : v[0][2];
    const uint32_t sa = __shfl_sync(0xffffffffu, ca, lane & ~3);
    const uint32_t sb = __shfl_sync(0xffffffffu, cb, lane & ~3);
    float acc[kMaxTiles][4];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int kk = 0; kk < T; kk += 16) {
      const uint32_t k = static_cast<uint32_t>(kk + 2 * t4);
      const uint32_t a0 = onehot2(sa, k), a1 = onehot2(sb, k);
      const uint32_t a2 = onehot2(sa, k + 8u), a3 = onehot2(sb, k + 8u);
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        if (t < tiles) {
          const uint32_t* b = staged + (t * 8 + g) * stride + (kk >> 1) + t4;
          mma16816(acc[t], a0, a1, a2, a3, b[0], b[4]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[t][e] = (v[t][e] + static_cast<uint32_t>(__float2int_rz(acc[t][e]))) & mask;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kBlockCols / 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      if (row < B) out[static_cast<int64_t>(row) * ncols + c0 + t * 8 + 2 * t4 + (e & 1)] = v[t][e];
    }
  }
}

// -------------------------------------------------------------- gather2d

enum G2Mode { kSublaneOnce = 0, kSublaneChain = 1, kGather2dFirst = 2, kGather2dAll = 3 };

__global__ void __launch_bounds__(1024)
    gather2d_kernel(const uint32_t* __restrict__ tab, const uint32_t* __restrict__ idx, int reps,
                    uint32_t mask, int mode, int sum_out, uint32_t* __restrict__ out) {
  __shared__ uint32_t tab_s[8][128];
  __shared__ uint32_t idx_s[8][128];
  const int i = threadIdx.x >> 7;
  const int j = threadIdx.x & 127;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x;
  tab_s[i][j] = tab[threadIdx.x];
  uint32_t x = idx[at];
  __syncthreads();
  if (mode == kSublaneOnce) {
    x = tab_s[x & 7u][j];
  } else if (mode == kSublaneChain) {
    x &= 7u;
    for (int r = 0; r < reps; ++r) x = (tab_s[x][j] + x) & 7u;
  } else {
    const bool gathers = mode == kGather2dAll || blockIdx.x == 0;  // uniform in the block
    const uint32_t add_r = mode == kGather2dAll ? 1u : 0u;
    for (int r = 0; r < reps; ++r) {
      uint32_t v = 0u;
      if (gathers) {
        idx_s[i][j] = x;
        __syncthreads();
        const uint32_t lane = x & 127u;
        v = tab_s[(idx_s[i][lane] >> 7) & 7u][lane];
        __syncthreads();
      }
      x = (x + v + add_r * static_cast<uint32_t>(r)) & mask;
    }
  }
  if (sum_out) {
    block_sum(x, out);
  } else {
    out[at] = x;
  }
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

// tabT: fp16[ncols][T] (integers < 2048); idx, out: uint32[B][ncols].
int onehot_mma(const void* tabT, int T, int ncols, const void* idx, int B, int reps, void* out,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 16 || T % 16 != 0 || (T & (T - 1)) != 0 || ncols < kBlockCols ||
      ncols % kBlockCols != 0 || B < 1 || reps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = ncols > kBlockCols ? kMaxTiles : kBlockCols / 8;
  const size_t smem = static_cast<size_t>(tiles) * 8u * static_cast<size_t>(T + 8) * 2u;
  if (smem > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + 16 * kMmaWarps - 1) / (16 * kMmaWarps), ncols / kBlockCols);
  onehot_kernel<<<grid, kMmaWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tabT), T, ncols, static_cast<const uint32_t*>(idx), B, reps,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tab: uint32[8][128]; idx: uint32[tiles * 8][128]; out like idx, or
// uint32[1] (zeroed) with sum_out.
int gather2d(const void* tab, const void* idx, int64_t tiles, int reps, int64_t mask, int mode,
             int sum_out, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles < 1 || reps < 0 || mode < kSublaneOnce || mode > kGather2dAll || mask < 0 ||
      mask > 0xffffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather2d_kernel<<<static_cast<unsigned>(tiles), 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const uint32_t*>(idx), reps,
      static_cast<uint32_t>(mask), mode, sum_out, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
