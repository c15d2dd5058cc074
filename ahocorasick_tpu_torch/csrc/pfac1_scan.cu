// The PFAC v1 walk (pfac1_planes) behind a plain C interface loaded with
// ctypes (kernels/build.py builds it, kernels/scan_pfac.py binds it).  It
// replaces ahocorasick_tpu/ops/scan_pfac.py pfac_bitplanes (the fori_loop at
// :74): START-indexed depth bitplanes from trie_next and is_match.  The
// kernel and what bounds it: pfac1_walk.cuh.  It shares no code or table
// with the v2 walk (pfac_scan.cu, pfac_walk.cuh): v1 is the independent walk
// the tests hold v2 against.

#include <cstdint>

#include <cuda_runtime.h>

#include "pfac1_walk.cuh"

extern "C" {

// trie: uint32[S, stride]; is_match: uint8[>= S]; cls: the padded classes,
// n + depth of them; out: uint32[num_planes, n].  The launch (grid, two_level)
// is kernels/scan_pfac.pfac1_plan's.
int pfac1_planes(const void* trie, int stride, int64_t states, const void* is_match,
                 int64_t dead, const void* cls, int cls_bytes, int64_t n, int depth,
                 int num_planes, int grid, int two_level, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac1::Walk w{};
  w.trie = static_cast<const uint32_t*>(trie);
  w.is_match = static_cast<const uint8_t*>(is_match);
  w.cls = cls;
  w.planes = static_cast<uint32_t*>(out);
  w.n = n;
  w.states = states;
  w.dead = static_cast<uint32_t>(dead);
  w.stride = stride;
  w.depth = depth;
  w.num_planes = num_planes;
  w.two_level = two_level;
  return pfac1::launch(w, cls_bytes, static_cast<unsigned>(grid),
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
