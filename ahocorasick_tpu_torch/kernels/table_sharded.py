"""Row-sharded packed-DFA lane scan: the Hopper kernel and its plain PyTorch
twin.

One kernel (``csrc/table_sharded.cu``) replaces the ``shard_map`` body of
``ahocorasick_tpu/parallel/sharding.py`` ``_table_sharded_build``: the packed
table ``uint32[S, A]`` (``next | payload << state_bits``) is cut into
``n_model`` contiguous row slices of ``rows_per`` rows, and per character the
word of state ``s`` comes from the one shard that owns it
(``k = s // rows_per``).  The JAX body has every device look its own slice up
under a mask and combines the words with a ``psum`` per character; the kernel
reads the owning shard directly through an array of base pointers, staged
in each block's shared memory, and finds the owner with a multiply-add and a
shift (``division_constants``) in place of the division.

``ShardedTable`` holds the shards, each a **separate allocation** (also when
several lie on one card).  On a CUDA device they may lie on the scanning
device or on other GPUs of the host; the launcher then maps each owner as a
peer and raises where it cannot.  Only the one-card form has been run: the
peer form is unverified.

``table_sharded_scan(table, windows, halo, state_bits, mode)`` scans the
``chunk_classes`` windows (``uint8``, ``uint16`` or ``int32[B, halo + C]``) in
one of five modes (payload = the bits above ``state_bits``):

* ``"count"`` — the payload is an emit mask: its total popcount, an int64
  scalar tensor;
* ``"count_packed"`` — the payload is an emit count: its total sum;
* ``"planes"`` — the payload per position, ``uint32[1, B * C]`` in flat text
  order (the contract of ``packed_scan_planes``);
* ``"hotstate"`` — the whole word where the payload is not 0, else 0 (the
  contract of ``packedcount_hotstate_plane``);
* ``"raw"`` — the whole word at every position (the whole-word-longest path
  sweeps it where it lies, ``ops.scan_wwl.walks_from_raw``).

The kernel runs the single-table scans' lane loops (``csrc/tile.cuh``): K
lanes per window, each warmed from the root over the ``halo`` classes before
its segment (``kernels/scan_block.py`` ``segments``: the counts under
``COUNT_MAX_LANES``, the planes modes under ``MAX_LANES``; K = 1 where halo =
0), and the plain twin scans the same segments.

Under a process group no rank can read another's rows, and the JAX body
runs as written: ``group_scan`` drives one launch of ``table_sharded_step``
(the same source) per character on this rank's own shard, and between
launches the caller's reduction, an ``all_reduce(SUM)`` of the lanes' words
over the model ranks, gives every rank the word of the one rank that owns
the state.  A step costs a launch and a collective, both nearly fixed, so
the loop has lanes of its own, wider than the single launch's
(``step_segments``: up to ``STEP_MAX_K[mode]`` a window), and a call takes ``halo
+ L`` steps, and one more launch folds the last position.  One prep launch a
call, ``step_classes`` (``table_sharded_classes``), lays the lanes' classes
out class-major, ``[halo + L, B * K]``, so that a step reads one contiguous
row.  Where the caller hands ``group_scan`` a ``StepGraphs`` (an NCCL model
axis of more than one rank), the loop is captured as a CUDA graph on a
shape's second call and replayed from then on.

The wrappers run the plain twins for tensors on the CPU, and launch the
kernels for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, Optional, Sequence

import torch

from ahocorasick_tpu_torch.kernels import build, scan_block
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import (
    _popcount32, _segment_lanes, _to_uint32, _widen, segments)

MODES = ("count", "count_packed", "planes", "hotstate", "raw")
_WINDOW_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
# The shard pointers a block stages in shared memory beside the planes' store
# tile, within the 48 KiB a block gets without opting in: (49,152 - 256 x 17
# x 4) / 8 (csrc/table_sharded.cu kMaxShards).
MAX_SHARDS = 3_968


def division_constants(rows_per: int) -> tuple:
    """``(magic, add, shift)`` with ``(s * magic + add) >> shift == s //
    rows_per`` for every 32-bit ``s`` (the kernel computes it as one 32 x 32
    + 64-bit multiply-add and a shift).  With ``l = floor(log2 rows_per)``
    and ``shift = 32 + l``: a power of two takes ``magic = add = 2**32 - 1``;
    any other divisor the round-up method (``magic = ceil(2**shift /
    rows_per)``, ``add = 0``) where its error ``magic * rows_per - 2**shift``
    is at most ``2**l``, else the round-down method (``magic = add =
    floor(2**shift / rows_per)``), whose error is then at most ``2**l``
    (Robison, "N-bit unsigned division via N-bit multiply-add", 2005)."""
    if not 1 <= rows_per < 1 << 32:
        raise ValueError(f"rows_per={rows_per} is not in 1 .. 2**32 - 1")
    log = rows_per.bit_length() - 1
    shift = 32 + log
    if rows_per & (rows_per - 1) == 0:
        return (1 << 32) - 1, (1 << 32) - 1, shift
    up = -(-(1 << shift) // rows_per)
    if up * rows_per - (1 << shift) <= 1 << log:
        return up, 0, shift
    down = (1 << shift) // rows_per
    return down, down, shift


def lane_segments(num_windows: int, body: int, halo: int, mode: str) -> tuple:
    """``(K, L)`` of the kernel and its twin: the counts' rule under
    ``COUNT_MAX_LANES``, the planes modes' under ``MAX_LANES`` (both read
    from ``kernels.scan_block`` at each call)."""
    counting = mode in ("count", "count_packed")
    cap = scan_block.COUNT_MAX_LANES if counting else scan_block.MAX_LANES
    return segments(num_windows, body, halo, cap)


class ShardedTable:
    """The row shards of one packed table: ``n_model`` contiguous
    ``uint32[rows_per, A]`` tensors, shard k holding rows
    ``[k * rows_per, (k + 1) * rows_per)`` (the last one zero-padded), and,
    per scanning CUDA device, the device array of their base pointers, and
    the constants that divide a state by ``rows_per``
    (``division_constants``)."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        shards = list(shards)
        if not shards:
            raise ValueError("a sharded table needs at least one shard")
        shape = shards[0].shape
        for t in shards:
            if t.dtype != torch.uint32 or t.dim() != 2 or t.shape != shape:
                raise TypeError(
                    "shards must be uint32[rows_per, A] of one shape, got "
                    f"{t.dtype}{tuple(t.shape)} beside {tuple(shape)}")
            if not t.is_contiguous():
                raise ValueError("shards must be contiguous")
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError(f"empty shards {tuple(shape)}")
        if len({t.device.type for t in shards}) != 1:
            raise ValueError("shards lie on devices of different types")
        self.shards = shards
        self.rows_per, self.stride = int(shape[0]), int(shape[1])
        self.divisor = division_constants(self.rows_per)
        self._pointers = {}

    @property
    def n_model(self) -> int:
        return len(self.shards)

    @property
    def device_type(self) -> str:
        return self.shards[0].device.type

    def pointers(self, device: torch.device) -> torch.Tensor:
        """``int64[n_model]`` on ``device``: the shards' base addresses."""
        key = (device.type, device.index)
        if key not in self._pointers:
            self._pointers[key] = torch.tensor(
                [t.data_ptr() for t in self.shards], dtype=torch.int64, device=device)
        return self._pointers[key]


def _check_windows(windows: torch.Tensor, halo: int, state_bits: int, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if windows.dtype not in _WINDOW_BYTES or windows.dim() != 2:
        raise TypeError("windows must be uint8, uint16 or int32[B, W], got "
                        f"{windows.dtype}{tuple(windows.shape)}")
    if not windows.is_contiguous():
        raise ValueError("windows must be contiguous")
    B, W = windows.shape
    if B < 1 or not 0 <= halo < W:
        raise ValueError(f"need B >= 1 and 0 <= halo < W; got B={B}, W={W}, halo={halo}")
    if not 1 <= state_bits <= 31:
        raise ValueError(f"state_bits={state_bits} is not in 1..31")
    if windows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {windows.device}")
    return B, W


def _check(table: ShardedTable, windows: torch.Tensor, halo: int, state_bits: int, mode: str):
    B, W = _check_windows(windows, halo, state_bits, mode)
    if table.device_type != windows.device.type:
        raise ValueError(f"shards on {table.device_type}, windows on {windows.device}")
    if table.n_model > MAX_SHARDS:
        raise ValueError(f"{table.n_model} shards: a block stages at most MAX_SHARDS = "
                         f"{MAX_SHARDS} shard pointers in shared memory")
    return B, W


def table_sharded_scan(table: ShardedTable, windows: torch.Tensor, halo: int, state_bits: int,
                       mode: str) -> torch.Tensor:
    """The scan of ``windows`` over the row shards in ``mode``: an int64
    scalar tensor (the counts) or ``uint32[1, B * C]`` (the planes) on the
    windows' device."""
    B, W = _check(table, windows, halo, state_bits, mode)
    if windows.device.type == "cpu":
        return table_sharded_scan_plain(table, windows, halo, state_bits, mode)
    dev = windows.device
    if mode in ("count", "count_packed"):
        out = torch.zeros(1, dtype=torch.int64, device=dev)
    else:
        out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=dev)
    owners = (ctypes.c_int * table.n_model)(*[t.device.index for t in table.shards])
    build.call("table_sharded_scan", table.pointers(dev).data_ptr(), owners, table.n_model,
               table.rows_per, table.stride, *table.divisor, windows.data_ptr(),
               _WINDOW_BYTES[windows.dtype], B, W, halo, state_bits, MODES.index(mode),
               *lane_segments(B, W - halo, halo, mode), out.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches["table_sharded_scan"] += 1
    return out[0] if out.dtype == torch.int64 else out


# ----------------------------------------------------------------- plain twin
#
# The JAX body step by step: a Python loop over the window columns, each a
# masked lookup per shard summed over the shards, on int64 copies of the
# shards and windows (torch has no uint32 shift or popcount).  The twins scan
# the kernels' lanes (``lane_segments``), so the kernel's one-owner read with
# its multiply-add, and the step kernel's masked read of one shard, are held
# against the JAX formula on the same segments.


def shard_lookup(shard: torch.Tensor, k: int, rows_per: int, stride: int):
    """``lookup(s, c)`` of shard k (``uint32[rows_per, stride]``) over int64
    lanes: the word of the lanes whose state the shard owns, 0 for the
    others."""
    shard64 = _widen(shard.reshape(-1))
    lo = k * rows_per

    def lookup(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        rel = s - lo
        mine = (rel >= 0) & (rel < rows_per)
        return torch.where(mine, shard64[torch.where(mine, rel, 0) * stride + c], 0)

    return lookup


def _scan_lanes(lookup: Callable, lanes: torch.Tensor, halo: int, state_bits: int, mode: str,
                limit: Optional[torch.Tensor]) -> torch.Tensor:
    """The column loop over ``lanes[N, halo + L]``: the count (body positions
    ``j < limit[lane]`` only) as an int64 scalar, or the lanes' values
    ``int64[N, L]`` (``limit`` None: the planes modes keep every position)."""
    N, W = lanes.shape
    smask = (1 << state_bits) - 1
    counting = mode in ("count", "count_packed")
    acc = torch.zeros(N, dtype=torch.int64, device=lanes.device)
    out = None if counting else torch.empty((N, W - halo), dtype=torch.int64,
                                            device=lanes.device)
    s = torch.zeros(N, dtype=torch.int64, device=lanes.device)
    for t in range(W):
        col = lanes[:, t]
        v = lookup(s, col.to(torch.int64) if col.dtype == torch.int32 else _widen(col))
        if t >= halo:
            hi = v >> state_bits
            if mode == "count":
                acc.add_(torch.where(t - halo < limit, _popcount32(hi), 0))
            elif mode == "count_packed":
                acc.add_(torch.where(t - halo < limit, hi, 0))
            elif mode == "planes":
                out[:, t - halo] = hi
            elif mode == "hotstate":
                out[:, t - halo] = torch.where(hi != 0, v, 0)
            else:
                out[:, t - halo] = v
        s = v & smask
    return acc.sum() if counting else out


def table_sharded_scan_plain(table: ShardedTable, windows: torch.Tensor, halo: int,
                             state_bits: int, mode: str) -> torch.Tensor:
    """The kernel's lane decomposition (``lane_segments``): each count lane
    counts its own body positions only, the planes' padding past a window's
    body is dropped."""
    dev = windows.device
    B, W = windows.shape
    C = W - halo
    K, L = lane_segments(B, C, halo, mode)
    lookups = [shard_lookup(t.view(torch.int32).to(dev).view(torch.uint32), k, table.rows_per,
                            table.stride)
               for k, t in enumerate(table.shards)]

    def lookup(s, c):
        v = lookups[0](s, c)
        for fn in lookups[1:]:
            v = v + fn(s, c)
        return v

    lanes = _segment_lanes(windows, halo, K, L)
    if mode in ("count", "count_packed"):
        # Body positions each lane holds: L, the last lane of a window the rest.
        limit = (C - torch.arange(K, device=dev) * L).clamp(max=L).repeat(B)
        return _scan_lanes(lookup, lanes, halo, state_bits, mode, limit)
    out = _scan_lanes(lookup, lanes, halo, state_bits, mode, None)
    return _to_uint32(out.reshape(B, K * L)[:, :C].reshape(1, -1))


# ------------------------------------------------- the step loop of one rank
#
# Its lanes: K lanes a window of L = ceil(C / K) body positions (the last
# one the rest), each warmed over the halo, as the single launch's, but with
# K chosen for a loop whose every step costs a launch and a collective: the
# number of steps, halo + L, falls with K while a step's lanes, B * K, rise.
# STEP_MAX_K holds, by mode, the K that minimised the loop at the main
# path's three shapes on an H100 (PERF.md; chip_smoke.py's "step K sweep"
# lines: K = 1 to 32, each loop replayed from its CUDA graph with an NCCL
# all_reduce at world 1): 16 for the counts (the 10k and 1M tables),
# 32 for the planes modes, whose step also stores a word a lane at its own
# position, L words from the next lane's.  A collective of more than one
# rank costs more a step and would favour a larger K still.
# STEP_MAX_LANES keeps the words and classes of a call within a few tens of
# MB where windows are many.

STEP_MAX_K = {"count": 16, "count_packed": 16, "planes": 32, "hotstate": 32, "raw": 32}
STEP_MAX_LANES = 1 << 21
STEP_MAX_SEGMENTS = 32  # csrc/table_sharded.cu kMaxStepSegments


def step_segments(num_windows: int, body: int, halo: int, mode: str) -> tuple:
    """``(K, L)`` of the step loop: the largest power of two K up to
    ``STEP_MAX_K[mode]`` (both constants read at each call) with
    ``num_windows * K`` within ``STEP_MAX_LANES``, then ``L = ceil(C / K)``
    and K cut to ``ceil(C / L)`` so that the last lane is not empty; K = 1
    where ``halo = 0`` (no warm-up synchronizes)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    k = 1
    if halo >= 1:
        while (k * 2 <= min(STEP_MAX_K[mode], STEP_MAX_SEGMENTS)
               and num_windows * k * 2 <= STEP_MAX_LANES):
            k *= 2
    L = -(-body // k)
    K = -(-body // L)
    return (K, L) if K > 1 else (1, body)


def valid_step_segments(segments: tuple, body: int, halo: int) -> bool:
    """The splits ``step_segments`` makes: ``(1, C)``, or, where ``halo >=
    1``, K in 2 .. ``STEP_MAX_SEGMENTS`` and ``L = ceil(C / K)`` with ``(K -
    1) * L < C`` (``csrc/table_sharded.cu`` ``valid_step_segments``)."""
    K, L = segments
    if K == 1:
        return L == body
    return (2 <= K <= STEP_MAX_SEGMENTS and halo >= 1 and body >= 1
            and L == -(-body // K) and (K - 1) * L < body)


def _check_segments(windows: torch.Tensor, halo: int, segments: tuple) -> None:
    """Raises on windows or a split that the prep does not take."""
    if windows.dtype not in _WINDOW_BYTES or windows.dim() != 2 or not windows.is_contiguous():
        raise TypeError("windows must be contiguous uint8, uint16 or int32[B, W], got "
                        f"{windows.dtype}{tuple(windows.shape)}")
    if windows.shape[0] < 1 or not 0 <= halo < windows.shape[1]:
        raise ValueError(f"need B >= 1 and 0 <= halo < W; got {tuple(windows.shape)}, "
                         f"halo={halo}")
    if not valid_step_segments(segments, windows.shape[1] - halo, halo):
        raise ValueError(f"segments {segments} do not cut a body of "
                         f"{windows.shape[1] - halo} (halo {halo}) as step_segments does")


def step_classes(windows: torch.Tensor, halo: int, segments: tuple,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step loop's classes, class-major: ``classes[t, b * K + k]`` is
    lane ``b * K + k``'s class at step t, row b's class ``k * L + t`` (0 past
    the row), ``[halo + L, B * K]`` of the windows' type, written into
    ``out`` where given."""
    B, W = windows.shape
    K, L = segments
    _check_segments(windows, halo, segments)
    shape = (halo + L, B * K)
    if out is None:
        out = torch.empty(shape, dtype=windows.dtype, device=windows.device)
    elif out.dtype != windows.dtype or tuple(out.shape) != shape or not out.is_contiguous() \
            or out.device != windows.device:
        raise TypeError(f"out must be a contiguous {windows.dtype}{shape} on {windows.device}, "
                        f"got {out.dtype}{tuple(out.shape)} on {out.device}")
    if windows.device.type == "cpu":
        out.view(_signed(out.dtype)).copy_(step_classes_plain(windows, halo, segments)
                                           .view(_signed(out.dtype)))
        return out
    dev = windows.device
    build.call("table_sharded_classes", windows.data_ptr(), _WINDOW_BYTES[windows.dtype], B, W,
               halo, K, L, out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    launches["table_sharded_classes"] += 1
    return out


def _signed(dtype: torch.dtype) -> torch.dtype:
    """The type whose copies and transposes carry ``dtype``'s bits (uint16 has
    no copy kernel on every build)."""
    return torch.int16 if dtype == torch.uint16 else dtype


def step_classes_plain(windows: torch.Tensor, halo: int, segments: tuple) -> torch.Tensor:
    """The twin of ``step_classes``: ``_segment_lanes``' rows of the lanes,
    transposed."""
    K, L = segments
    _check_segments(windows, halo, segments)
    bits = windows.view(_signed(windows.dtype))
    lanes = _segment_lanes(bits, halo, K, L)
    return lanes.t().contiguous().view(windows.dtype)


def _check_step(shard: torch.Tensor, words: torch.Tensor, classes: torch.Tensor, t: int,
                halo: int, state_bits: int, mode: str, segments: tuple, body: int,
                out: torch.Tensor, total: Optional[torch.Tensor]) -> tuple:
    """Raises on buffers the step does not take; returns ``(B, W)`` of the
    windows the classes came from."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    K, L = segments
    if classes.dtype not in _WINDOW_BYTES or classes.dim() != 2 or not classes.is_contiguous():
        raise TypeError("classes must be a contiguous uint8, uint16 or int32[halo + L, B * K], "
                        f"got {classes.dtype}{tuple(classes.shape)}")
    if not 1 <= state_bits <= 31:
        raise ValueError(f"state_bits={state_bits} is not in 1..31")
    if halo < 0 or body < 1 or not valid_step_segments(segments, body, halo):
        raise ValueError(f"segments {segments} do not cut a body of {body} (halo {halo}) as "
                         f"step_segments does")
    if classes.shape[1] % K or classes.shape[1] < K:
        raise ValueError(f"classes of {classes.shape[1]} lanes are not B windows of {K} lanes")
    B, W = classes.shape[1] // K, halo + body
    if classes.shape[0] != halo + L:
        raise ValueError(f"classes of {classes.shape[0]} steps, not halo + L = {halo + L}")
    if not 0 <= t <= halo + L:
        raise ValueError(f"step {t} is not in 0 .. halo + L = {halo + L}")
    if shard.dtype != torch.uint32 or shard.dim() != 2 or not shard.is_contiguous() \
            or min(shard.shape) < 1:
        raise TypeError(f"the shard must be a contiguous uint32[rows_per, A], got "
                        f"{shard.dtype}{tuple(shard.shape)}")
    counting = mode in ("count", "count_packed")
    want = {"words": (words, torch.uint32, (B * K,))}
    if counting:
        want["out"] = (out, torch.int64, (B * K,))
        want["total"] = (total, torch.int64, (1,))
    else:
        want["out"] = (out, torch.uint32, (1, B * body))
    for name, (x, dtype, shape) in want.items():
        if x is None or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype}{shape}, got "
                            f"{None if x is None else (x.dtype, tuple(x.shape))}")
    for x in (shard, words, out):
        if x.device != classes.device:
            raise ValueError(f"tensors on {x.device} and {classes.device}")
    if classes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {classes.device}")
    return B, W


def table_sharded_step(shard: torch.Tensor, k: int, words: torch.Tensor, classes: torch.Tensor,
                       t: int, halo: int, state_bits: int, mode: str, segments: tuple, body: int,
                       out: torch.Tensor, total: Optional[torch.Tensor] = None) -> None:
    """Launch ``t`` of one rank's step loop, in place: ``shard`` is row shard
    ``k`` (``uint32[rows_per, A]``, states ``[k * rows_per, (k + 1) *
    rows_per)``); ``classes`` the class-major classes of B windows of ``halo
    + body`` (``step_classes``, ``segments = (K, L)`` as ``step_segments``
    makes them); ``words`` (``uint32[B * K]``) holds the lanes' words of
    position ``t - 1`` as the last ``all_reduce`` left them.  The launch
    folds them into ``out`` (the lanes' ``int64[B * K]`` accumulators for the
    counts, else the ``uint32[1, B * body]`` plane) and, for ``t < halo +
    L``, writes the lanes' words of step ``t`` from this shard (0 where it
    does not own the state) into ``words``; launch ``t = halo + L`` adds the
    accumulators to ``total`` (``int64[1]``, counts only)."""
    B, W = _check_step(shard, words, classes, t, halo, state_bits, mode, segments, body, out,
                       total)
    _step(shard, k, words, classes, (B, W), t, halo, state_bits, mode, segments, out, total)


def _step(shard: torch.Tensor, k: int, words: torch.Tensor, classes: torch.Tensor, shape: tuple,
          t: int, halo: int, state_bits: int, mode: str, segments: tuple, out: torch.Tensor,
          total: Optional[torch.Tensor]) -> None:
    """``table_sharded_step`` on buffers ``_check_step`` has passed (``shape``
    the windows' ``(B, W)``)."""
    B, W = shape
    if classes.device.type == "cpu":
        return table_sharded_step_plain(shard, k, words, classes, t, halo, state_bits, mode,
                                        segments, W - halo, out, total)
    dev = classes.device
    rows_per, stride = shard.shape
    build.call("table_sharded_step", shard.data_ptr(), rows_per, stride, k * rows_per,
               classes.data_ptr(), _WINDOW_BYTES[classes.dtype], B, W, halo, state_bits,
               MODES.index(mode), *segments, t, words.data_ptr(), out.data_ptr(),
               0 if total is None else total.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches["table_sharded_step"] += 1


def table_sharded_step_plain(shard: torch.Tensor, k: int, words: torch.Tensor,
                             classes: torch.Tensor, t: int, halo: int, state_bits: int, mode: str,
                             segments: tuple, body: int, out: torch.Tensor,
                             total: Optional[torch.Tensor] = None) -> None:
    """The twin of ``table_sharded_step`` on the same buffers:
    ``shard_lookup`` of the one shard at row ``t`` of the class-major
    classes."""
    K, L = segments
    C = body
    dev = classes.device
    lane = torch.arange(classes.shape[1], device=dev)
    b, start = lane // K, (lane % K) * L
    v = _widen(words)
    j = t - 1 - halo
    if j >= 0:
        hi = v >> state_bits
        fold = j < (C - start).clamp(max=L)
        if mode == "count":
            out.add_(torch.where(fold, _popcount32(hi), 0))
        elif mode == "count_packed":
            out.add_(torch.where(fold, hi, 0))
        else:
            value = hi if mode == "planes" else torch.where(hi != 0, v, 0) if mode == "hotstate" \
                else v
            pos = (b * C + start + j)[fold]
            out.view(torch.int32).view(-1)[pos] = _to_uint32(value[fold]).view(torch.int32)
    if t < halo + L:
        col = classes[t]
        col = col.to(torch.int64) if col.dtype == torch.int32 else _widen(col)
        lookup = shard_lookup(shard, k, shard.shape[0], shard.shape[1])
        w = lookup(v & ((1 << state_bits) - 1), col)
        words.view(torch.int32).copy_(_to_uint32(w).view(torch.int32))
    elif mode in ("count", "count_packed"):
        total.add_(out.sum())


def _loop_buffers(ranks: Sequence[tuple], windows: torch.Tensor, halo: int, state_bits: int,
                  mode: str, segments: tuple) -> tuple:
    """``(classes, bufs)``: the class-major classes and each driven rank's
    ``(k, shard, words, out, total)``, checked once (``_check_step``); the
    planes uninitialised (every body position is written once), the rest
    zeroed by ``_loop``."""
    B, W = windows.shape
    K, L = segments
    dev = windows.device
    counting = mode in ("count", "count_packed")
    classes = torch.empty((halo + L, B * K), dtype=windows.dtype, device=dev)
    bufs = []
    for k, shard in ranks:
        words = torch.empty(B * K, dtype=torch.uint32, device=dev)
        if counting:
            out = torch.empty(B * K, dtype=torch.int64, device=dev)
            total = torch.empty(1, dtype=torch.int64, device=dev)
        else:
            out, total = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=dev), None
        _check_step(shard, words, classes, 0, halo, state_bits, mode, segments, W - halo, out,
                    total)
        bufs.append((k, shard, words, out, total))
    return classes, bufs


def _loop(bufs: list, windows: torch.Tensor, classes: torch.Tensor, halo: int, state_bits: int,
          mode: str, segments: tuple, reduce: Callable) -> None:
    """One call of the step loop on buffers that ``_check_step`` has passed:
    the prep, the zeroed words and accumulators, ``halo + L + 1`` launches a
    driven rank and ``halo + L`` reductions.  No host sync inside: a stream
    capture can hold all of it."""
    _, L = segments
    step_classes(windows, halo, segments, classes)
    for _, _, words, out, total in bufs:
        words.view(torch.int32).zero_()
        if total is not None:
            out.zero_()
            total.zero_()
    shape = tuple(windows.shape)
    for t in range(halo + L + 1):
        for k, shard, words, out, total in bufs:
            _step(shard, k, words, classes, shape, t, halo, state_bits, mode, segments, out, total)
        if t < halo + L:
            reduce([words for _, _, words, _, _ in bufs])


def _results(bufs: list, clone: bool) -> list:
    out = []
    for _, _, _, plane, total in bufs:
        x = total[0] if total is not None else plane
        if clone:
            x = x.clone() if total is not None else x.view(torch.int32).clone().view(torch.uint32)
        out.append(x)
    return out


class StepGraphs:
    """The step loops of one process group captured as CUDA graphs, at most
    ``MAX_GRAPHS`` of them (the least recently used goes first), keyed by the
    windows' shape and type, the mode, the halo, the state bits and the
    driven ranks' shards.  A key's first call runs eagerly and its second
    captures, so a shape seen once (a stream's feeds) costs no capture.  A
    graph holds its buffers: the windows it reads, the class-major classes,
    the words and the outputs (at the 10k cell's planes a 128 MiB plane and
    about 58 MiB of classes).  For collectives a stream capture can hold
    (NCCL; gloo's cannot)."""

    MAX_GRAPHS = 2  # keys kept, captured and seen once alike

    def __init__(self):
        self._graphs = collections.OrderedDict()
        self._seen = collections.OrderedDict()  # keys run once, eagerly

    def __len__(self) -> int:
        return len(self._graphs)

    def scan(self, ranks: Sequence[tuple], windows: torch.Tensor, halo: int, state_bits: int,
             mode: str, reduce: Callable, segments: tuple) -> list:
        """``group_scan``'s result: the first call of a key runs the loop
        eagerly (every kernel's first launch, and the collective's first call,
        outside any capture); the second captures it; from then on a call
        copies the windows into the captured buffer, replays and clones the
        results out."""
        key = (tuple(windows.shape), windows.dtype, mode, halo, state_bits,
               tuple((k, shard.data_ptr()) for k, shard in ranks))
        if key not in self._graphs:
            if key not in self._seen:
                _remember(self._seen, key, True, self.MAX_GRAPHS)
                return _eager(ranks, windows, halo, state_bits, mode, reduce, segments)
            del self._seen[key]
            _remember(self._graphs, key, self._capture(ranks, windows, halo, state_bits, mode,
                                                       reduce, segments), self.MAX_GRAPHS)
        self._graphs.move_to_end(key)
        graph, static, _, bufs, steps = self._graphs[key]
        static.view(_signed(static.dtype)).copy_(windows.view(_signed(windows.dtype)))
        graph.replay()
        launches["table_sharded_classes"] += 1
        launches["table_sharded_step"] += steps * len(bufs)
        return _results(bufs, clone=True)

    @staticmethod
    def _capture(ranks, windows, halo, state_bits, mode, reduce, segments) -> tuple:
        static = windows.view(_signed(windows.dtype)).clone().view(windows.dtype)
        classes, bufs = _loop_buffers(ranks, static, halo, state_bits, mode, segments)
        graph = torch.cuda.CUDAGraph()
        counted = dict(launches)  # the capture launches nothing
        try:
            with torch.cuda.graph(graph):
                _loop(bufs, static, classes, halo, state_bits, mode, segments, reduce)
        finally:
            launches.update(counted)
        # The graph's prep writes into ``classes`` at every replay: the entry
        # holds it, or its memory would go back to the allocator.
        return graph, static, classes, bufs, halo + segments[1] + 1


def _remember(cache: collections.OrderedDict, key, value, bound: int) -> None:
    cache[key] = value
    while len(cache) > bound:
        cache.popitem(last=False)


def _eager(ranks, windows, halo, state_bits, mode, reduce, segments) -> list:
    classes, bufs = _loop_buffers(ranks, windows, halo, state_bits, mode, segments)
    _loop(bufs, windows, classes, halo, state_bits, mode, segments, reduce)
    return _results(bufs, clone=False)


def group_scan(ranks: Sequence[tuple], windows: torch.Tensor, halo: int, state_bits: int,
               mode: str, reduce: Callable, graphs: Optional[StepGraphs] = None) -> list:
    """The table-sharded scan of ``windows`` as the ranks of a process group
    run it: ``ranks`` holds ``(k, shard)`` of each rank this process drives
    (this process's one rank under a group; every rank where a test
    simulates them), each shard on the windows' device.  One prep launch
    (``step_classes``), then per step one ``table_sharded_step`` a rank and
    ``reduce(words)``, which must leave in each of the ranks' word buffers
    (``uint32[B * K]``) the sum of every rank's: an ``all_reduce(SUM)`` over
    the model ranks (exact: at most one rank's word is not 0).  The lanes are
    ``step_segments``'.  No host sync inside the loop.  With ``graphs`` and
    CUDA windows the loop runs as a captured CUDA graph (``StepGraphs``:
    ``reduce`` must be capturable).  Returns each driven rank's result: an
    int64 scalar tensor (the counts) or the ``uint32[1, B * C]`` plane, as
    ``table_sharded_scan``.  The buffers are checked once, before the
    loop (a replay: when its graph was captured)."""
    B, W = _check_windows(windows, halo, state_bits, mode)
    segs = step_segments(B, W - halo, halo, mode)
    if graphs is not None and windows.device.type == "cuda":
        return graphs.scan(ranks, windows, halo, state_bits, mode, reduce, segs)
    return _eager(ranks, windows, halo, state_bits, mode, reduce, segs)
