"""Failureless parallel trie walk (PFAC): the Hopper kernel and its plain
PyTorch twins.

One walk kernel in three modes (``csrc/pfac_scan.cu``), replacing the JAX
package's cross-check loops ``ahocorasick_tpu/ops/scan_pfac2.py``
``pfac2_bitplanes`` / ``pfac2_count`` and ``ops/scan_pfac.py``
``pfac_bitplanes``:

* ``pfac2_planes(trie, prefix, threshold, cls, depth, num_planes, prefix_k,
  num_classes, dead_state)`` — START-indexed depth bitplanes
  ``uint32[num_planes, n]`` over the ranked tables of
  ``ops/scan_pfac2.build_ranked``: bit ``(L-1) % 32`` of plane ``(L-1) // 32``
  at column i means a keyword of length L starts at i;
* ``pfac2_count(...)`` — the total of those bits, an int64 scalar tensor;
* ``pfac1_planes(trie, is_match, cls, depth, num_planes, dead_state)`` — the
  same planes from the unranked trie and an ``is_match`` lookup per depth
  (``csrc/pfac1_scan.cu``, which shares nothing with v2).

``cls`` holds the ``pad_classes``-padded class ids (``uint8``, ``uint16`` or
``int32``): ``n = len(cls) - depth`` lanes, one per start.  ``trie`` is
``uint32`` (or ``int32``) ``[S, stride]``.  A lane stops at ``dead_state``,
which must absorb and emit nothing, as the ranked tables' dead state
(``RankedTables.dead_state``) and the padded trie's last row do.  The source
note in the ``.cu`` file says what bounds the kernel on the H100.

The v2 kernels (``csrc/pfac_walk.cuh``) run persistent blocks whose warps
each take a span of starts: a prefix pass over classes staged in shared
memory (the k-gram prefix table there too where it fits), then a warp queue
of the walks that go on; ``launch_shape`` is their rule for the grid, the
span and where the prefix table lives.  The v1 kernel
(``csrc/pfac1_walk.cuh``) runs persistent blocks that stage the root row
and the two-level table where they fit, then walk a start a thread,
grid-stride; ``pfac1_plan`` is its rule.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _popcount32, _to_uint32, _widen
from ahocorasick_tpu_torch.kernels.scan_wwl import _index

STATE_BITS = 28  # ops/scan_pfac2._STATE_BITS: packed prefix entries
_CLASS_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}

# The v2 walk's launch (csrc/pfac_walk.cuh).  bench/scan_variants.py pfac_ab
# set them on an H100 80GB HBM3 at 700 W, 10k dictionary, 32 Mi lanes (ms,
# planes / count): 1,024 threads, 8 starts a lane, 1 block an SM (64
# registers), the prefix table staged 0.1467 / 0.1037; 4 a lane 0.1853 /
# 0.1643; 512 threads, 2 blocks an SM 0.1931 / 0.1838; 2 blocks of 1,024
# (32 registers, spilling; the prefix read with __ldg) 0.4441 / 0.3818; the
# package's widths with the prefix read with __ldg 0.2886 / 0.1210.
THREADS = 1024  # threads a block: csrc/pfac_scan.cu kWalkThreads
PER_LANE = 8  # starts a lane takes in a prefix pass: csrc/pfac_scan.cu kWalkPerLane
BLOCKS_PER_SM = 1  # blocks an SM holds (registers: kWalkBlocks); a block's smem share
SM_SMEM = 233_472  # bytes of shared memory an H100 SM has for blocks (228 KB)
BLOCK_SMEM_MAX = 232_448  # a block's most dynamic shared memory (227 KB)
BLOCK_SMEM_RESERVED = 1024 + 256  # the CUDA runtime's 1 KB a block and the kernel's own sums
MAX_K = 3  # ops/scan_pfac2.build_ranked's largest prefix_k

# The v1 walk's launch (csrc/pfac1_walk.cuh): persistent blocks of
# V1_THREADS, V1_BLOCKS_PER_SM an SM (the kernel's register budget), each
# first staging the root row and the two-level table where the table fits
# V1_TWO_LEVEL_MAX bytes, then walking a start a thread, grid-stride.  Set
# by the A/B on an H100 80GB HBM3 at 700 W, 10k dictionary, 32 Mi lanes
# (card time, ms): 0.2922 against nothing staged 0.3283 and the first
# design 0.3293 (PERF.md, PR 24).
V1_THREADS = 512  # csrc/pfac1_walk.cuh kThreads
V1_BLOCKS_PER_SM = 4  # csrc/pfac1_walk.cuh kBlocks
V1_TWO_LEVEL_MAX = 16_384


class Shape(NamedTuple):
    """A v2 launch: ``grid`` persistent blocks of ``threads``; warp g takes
    starts ``[g * span, (g + 1) * span)``; the prefix table in shared memory
    (``prefix_shared``) or read with ``__ldg``; ``smem`` dynamic bytes;
    ``blocks_per_sm`` the blocks an SM holds at that size."""

    grid: int
    span: int
    prefix_shared: bool
    smem: int
    blocks_per_sm: int


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def warp_bytes(cls_bytes: int, per_lane: int) -> int:
    """A warp's shared memory (``pfac_walk.cuh`` ``WarpArea``): the stage of
    a prefix pass's classes and the queue of ``32 + 32 * per_lane`` walks,
    8 bytes each."""
    batch = 32 * per_lane
    return _round16((batch + MAX_K - 1) * cls_bytes) + 8 * (32 + batch)


def launch_shape(n: int, cls_bytes: int, prefix_entries: int, sm_count: int,
                 threads: int = None, per_lane: int = None, blocks: int = None) -> Shape:
    """The v2 launch for ``n`` starts with ``threads`` a block, ``per_lane``
    starts a lane in a prefix pass and ``blocks`` an SM (the kernel's
    register budget).  A block's shared-memory budget is an SM's over
    ``blocks``; the warps' areas take their share and the prefix table
    (``4 * prefix_entries`` bytes) is staged where it fits the rest.  The
    grid is as many blocks as fit on ``sm_count`` SMs, each warp a span of a
    multiple of 16 starts, and no more blocks than the starts need."""
    threads = THREADS if threads is None else threads
    per_lane = PER_LANE if per_lane is None else per_lane
    blocks = BLOCKS_PER_SM if blocks is None else blocks
    warps = threads // 32
    areas = warps * warp_bytes(cls_bytes, per_lane)
    prefix_bytes = _round16(4 * prefix_entries)
    budget = min(SM_SMEM // blocks - BLOCK_SMEM_RESERVED, BLOCK_SMEM_MAX)
    prefix_shared = prefix_bytes + areas <= budget
    smem = areas + (prefix_bytes if prefix_shared else 0)
    blocks_per_sm = max(1, min(blocks, SM_SMEM // (smem + BLOCK_SMEM_RESERVED)))
    span = -(-max(1, -(-n // (blocks_per_sm * sm_count * warps))) // 16) * 16
    grid = -(-(-(-n // span)) // warps)
    return Shape(grid, span, prefix_shared, smem, blocks_per_sm)


_SM_COUNT = {}


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors (cached a device)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


class Plan(NamedTuple):
    """A v1 launch: ``grid`` persistent blocks; ``two_level``: the root row
    and the two-level table ``trie[trie[0][c0]][c1]`` staged (else the root
    read with ``__ldg``); ``smem`` their dynamic bytes."""

    grid: int
    two_level: bool
    smem: int


def pfac1_smem(stride: int, two_level: bool) -> int:
    """A v1 block's shared memory (``pfac1_walk.cuh`` ``smem_bytes``): the
    root row and the two-level table, each rounded to 16 bytes, or none."""
    return _round16(4 * stride) + _round16(4 * stride * stride) if two_level else 0


def pfac1_plan(n: int, stride: int, sm_count: int) -> Plan:
    """The v1 launch for ``n`` starts over a trie of ``stride`` classes: the
    root row and the two-level table (``stride**2`` words) staged where the
    table fits ``V1_TWO_LEVEL_MAX`` bytes; as many blocks as the card
    holds, and no more than the starts' runs of ``V1_THREADS`` need."""
    two_level = 4 * stride * stride <= V1_TWO_LEVEL_MAX
    grid = max(1, min(-(-n // V1_THREADS), V1_BLOCKS_PER_SM * sm_count))
    return Plan(grid, two_level, pfac1_smem(stride, two_level))


def v1_plan(trie, cls, depth: int) -> Plan:
    """``pfac1_plan`` of a v1 call on ``cls`` (a CUDA tensor)."""
    return pfac1_plan(cls.numel() - depth, trie.shape[1], sm_count(cls.device))


def v2_shape(cls, depth: int, prefix) -> Shape:
    """``launch_shape`` of a v2 call on ``cls`` (a CUDA tensor)."""
    return launch_shape(cls.numel() - depth, _CLASS_BYTES[cls.dtype], prefix.numel(),
                        sm_count(cls.device))


def _check(name, trie, cls, depth, num_planes, *tables):
    if trie.dtype not in (torch.int32, torch.uint32) or trie.dim() != 2:
        raise TypeError(f"{name}: trie must be uint32 or int32[S, stride], got {trie.dtype}"
                        f"{tuple(trie.shape)}")
    if cls.dtype not in _CLASS_BYTES or cls.dim() != 1:
        raise TypeError(f"{name}: classes must be uint8, uint16 or int32[n + depth], got "
                        f"{cls.dtype}{tuple(cls.shape)}")
    for t in (trie, *tables):
        if t.device != cls.device:
            raise ValueError(f"{name}: table on {t.device}, classes on {cls.device}")
    if not all(t.is_contiguous() for t in (trie, cls, *tables)):
        raise ValueError(f"{name}: tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cls.device}")
    n = cls.numel() - depth
    if depth < 1 or n < 1 or num_planes < -(-depth // 32):
        raise ValueError(f"{name}: need depth >= 1, a lane and {-(-depth // 32)} planes; got "
                         f"depth={depth}, {cls.numel()} classes, {num_planes} planes")
    return n


def _check_v2(name, trie, prefix, cls, depth, num_planes, prefix_k, num_classes):
    if prefix.dtype != torch.uint32 or prefix.dim() != 1:
        raise TypeError(f"{name}: prefix must be uint32[A^k], got {prefix.dtype}")
    # The k-gram entries index the A^k table: a depth below k would read the
    # wrong gram's entry and silently drop every match.
    if not 1 <= prefix_k <= depth:
        raise ValueError(f"{name}: max_depth {depth} must be >= prefix_k {prefix_k} >= 1")
    if prefix.numel() != num_classes ** prefix_k:
        raise ValueError(f"{name}: prefix has {prefix.numel()} entries, not "
                         f"{num_classes}^{prefix_k}")
    return _check(name, trie, cls, depth, num_planes, prefix)


def _stream(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def pfac2_planes(trie, prefix, threshold: int, cls, depth: int, num_planes: int, prefix_k: int,
                 num_classes: int, dead_state: int) -> torch.Tensor:
    """START-indexed depth bitplanes ``uint32[num_planes, n]``."""
    n = _check_v2("pfac2_planes", trie, prefix, cls, depth, num_planes, prefix_k, num_classes)
    if cls.device.type == "cpu":
        return pfac2_planes_plain(trie, prefix, threshold, cls, depth, num_planes, prefix_k,
                                  num_classes)
    out = torch.empty((num_planes, n), dtype=torch.uint32, device=cls.device)
    sh = v2_shape(cls, depth, prefix)
    build.call("pfac2_planes", trie.data_ptr(), trie.shape[1], prefix.data_ptr(), threshold,
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], n, depth, prefix_k,
               num_classes, num_planes, sh.grid, sh.span, int(sh.prefix_shared),
               out.data_ptr(), *_stream(cls.device))
    launches["pfac2_planes"] += 1
    return out


def pfac2_count(trie, prefix, threshold: int, cls, depth: int, prefix_k: int, num_classes: int,
                dead_state: int) -> torch.Tensor:
    """The total match count of the walk, an int64 scalar tensor."""
    _check_v2("pfac2_count", trie, prefix, cls, depth, -(-depth // 32), prefix_k, num_classes)
    if cls.device.type == "cpu":
        return pfac2_count_plain(trie, prefix, threshold, cls, depth, prefix_k, num_classes)
    out = torch.zeros(1, dtype=torch.int64, device=cls.device)
    sh = v2_shape(cls, depth, prefix)
    build.call("pfac2_count", trie.data_ptr(), trie.shape[1], prefix.data_ptr(), threshold,
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], cls.numel() - depth,
               depth, prefix_k, num_classes, sh.grid, sh.span, int(sh.prefix_shared),
               out.data_ptr(), *_stream(cls.device))
    launches["pfac2_count"] += 1
    return out[0]


def pfac1_planes(trie, is_match, cls, depth: int, num_planes: int,
                 dead_state: int) -> torch.Tensor:
    """The v1 walk's START-indexed bitplanes ``uint32[num_planes, n]``."""
    if is_match.dtype != torch.bool or is_match.dim() != 1 or is_match.numel() < trie.shape[0]:
        raise TypeError(f"pfac1_planes: is_match must be bool[S >= {trie.shape[0]}], got "
                        f"{is_match.dtype}{tuple(is_match.shape)}")
    n = _check("pfac1_planes", trie, cls, depth, num_planes, is_match)
    if cls.device.type == "cpu":
        return pfac1_planes_plain(trie, is_match, cls, depth, num_planes)
    if trie.shape[0] > 1 << 31:
        raise ValueError(f"pfac1_planes: {trie.shape[0]} states; the kernel takes at most 2**31")
    out = torch.empty((num_planes, n), dtype=torch.uint32, device=cls.device)
    plan = v1_plan(trie, cls, depth)
    build.call("pfac1_planes", trie.data_ptr(), trie.shape[1], trie.shape[0], is_match.data_ptr(),
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], n, depth, num_planes,
               plan.grid, int(plan.two_level), out.data_ptr(), *_stream(cls.device))
    launches["pfac1_planes"] += 1
    return out


# ---------------------------------------------------------------- plain twins
#
# The JAX loops' algorithm: one batched lookup over the n lanes per depth,
# on int64 copies (torch has no uint32 shift), every depth walked.


def _gram_index(cls_padded: torch.Tensor, n: int, k: int, A: int) -> torch.Tensor:
    """The k-gram of classes starting at each of the n lanes, int64."""
    c = _index(cls_padded)
    idx = c[:n]
    for j in range(1, k):
        idx = idx * A + c[j: j + n]
    return idx


def _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit):
    """``hit(kk, bits)`` per depth kk in [k, depth) after the prefix lookup;
    returns the prefix's match bits (bit d - 1: a match at depth d <= k)."""
    n = cls.numel() - depth
    c = _index(cls)
    packed = _widen(prefix)[_gram_index(cls, n, prefix_k, num_classes)]
    st = packed & ((1 << STATE_BITS) - 1)
    hist = packed >> STATE_BITS  # bit j: a match at depth k - j
    first = torch.zeros_like(st)
    for d in range(1, prefix_k + 1):
        first |= ((hist >> (prefix_k - d)) & 1) << (d - 1)
    tf = _index(trie).reshape(-1)
    stride = trie.shape[1]
    for kk in range(prefix_k, depth):
        st = tf[st * stride + c[kk: kk + n]]
        hit(kk, (st >= threshold).to(torch.int64))
    return first


def pfac2_planes_plain(trie, prefix, threshold, cls, depth, num_planes, prefix_k, num_classes):
    n = cls.numel() - depth
    planes = torch.zeros((num_planes, n), dtype=torch.int64, device=cls.device)

    def hit(kk, bits):
        planes[kk // 32] |= bits << (kk % 32)

    planes[0] |= _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit)
    return _to_uint32(planes)


def pfac2_count_plain(trie, prefix, threshold, cls, depth, prefix_k, num_classes):
    total = torch.zeros((), dtype=torch.int64, device=cls.device)

    def hit(_kk, bits):
        total.add_(bits.sum())

    first = _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit)
    return total + _popcount32(first).sum()


def pfac1_planes_plain(trie, is_match, cls, depth, num_planes):
    n = cls.numel() - depth
    c = _index(cls)
    tf = _index(trie).reshape(-1)
    stride = trie.shape[1]
    m = is_match.to(torch.int64)
    planes = torch.zeros((num_planes, n), dtype=torch.int64, device=cls.device)
    st = tf[c[:n]]  # row 0: the root
    planes[0] = m[st]
    for kk in range(1, depth):
        st = tf[st * stride + c[kk: kk + n]]
        planes[kk // 32] |= m[st] << (kk % 32)
    return _to_uint32(planes)
