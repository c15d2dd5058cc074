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
the state.  The same lanes as above (``lane_segments``), so a call takes
``halo + L`` steps, and one more launch folds the last position.

The wrappers run the plain twins for tensors on the CPU, and launch the
kernels for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

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


def _check_step(shard: torch.Tensor, words: torch.Tensor, windows: torch.Tensor, t: int,
                halo: int, state_bits: int, mode: str, segments: tuple, out: torch.Tensor,
                total: Optional[torch.Tensor]) -> None:
    B, W = _check_windows(windows, halo, state_bits, mode)
    K, L = segments
    C = W - halo
    if not (K == 1 and L == C or 2 <= K <= 4 and halo >= 1 and L % 4 == 0
            and (K - 1) * L < C <= K * L):
        raise ValueError(f"segments {segments} do not cut a body of {C} (halo {halo})")
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
        want["out"] = (out, torch.uint32, (1, B * C))
    for name, (x, dtype, shape) in want.items():
        if x is None or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype}{shape}, got "
                            f"{None if x is None else (x.dtype, tuple(x.shape))}")
    for x in (shard, words, out):
        if x.device != windows.device:
            raise ValueError(f"tensors on {x.device} and {windows.device}")


def table_sharded_step(shard: torch.Tensor, k: int, words: torch.Tensor, windows: torch.Tensor,
                       t: int, halo: int, state_bits: int, mode: str, segments: tuple,
                       out: torch.Tensor, total: Optional[torch.Tensor] = None) -> None:
    """Launch ``t`` of one rank's step loop, in place: ``shard`` is row shard
    ``k`` (``uint32[rows_per, A]``, states ``[k * rows_per, (k + 1) *
    rows_per)``); ``words`` (``uint32[B * K]``, ``segments = (K, L)``) holds
    the lanes' words of position ``t - 1`` as the last ``all_reduce`` left
    them.  The launch folds them into ``out`` (the lanes' ``int64[B * K]``
    accumulators for the counts, else the ``uint32[1, B * C]`` plane) and,
    for ``t < halo + L``, writes the lanes' words of step ``t`` from this
    shard (0 where it does not own the state) into ``words``; launch ``t =
    halo + L`` adds the accumulators to ``total`` (``int64[1]``, counts
    only)."""
    _check_step(shard, words, windows, t, halo, state_bits, mode, segments, out, total)
    _step(shard, k, words, windows, t, halo, state_bits, mode, segments, out, total)


def _step(shard: torch.Tensor, k: int, words: torch.Tensor, windows: torch.Tensor, t: int,
          halo: int, state_bits: int, mode: str, segments: tuple, out: torch.Tensor,
          total: Optional[torch.Tensor]) -> None:
    """``table_sharded_step`` on buffers ``_check_step`` has passed."""
    if windows.device.type == "cpu":
        return table_sharded_step_plain(shard, k, words, windows, t, halo, state_bits, mode,
                                        segments, out, total)
    dev = windows.device
    rows_per, stride = shard.shape
    B, W = windows.shape
    build.call("table_sharded_step", shard.data_ptr(), rows_per, stride, k * rows_per,
               windows.data_ptr(), _WINDOW_BYTES[windows.dtype], B, W, halo, state_bits,
               MODES.index(mode), *segments, t, words.data_ptr(), out.data_ptr(),
               0 if total is None else total.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches["table_sharded_step"] += 1


def table_sharded_step_plain(shard: torch.Tensor, k: int, words: torch.Tensor,
                             windows: torch.Tensor, t: int, halo: int, state_bits: int, mode: str,
                             segments: tuple, out: torch.Tensor,
                             total: Optional[torch.Tensor] = None) -> None:
    """The twin of ``table_sharded_step`` on the same buffers: ``shard_lookup``
    of the one shard at the lanes' step-``t`` classes (0 past a window's
    row, as ``_segment_lanes`` pads)."""
    K, L = segments
    B, W = windows.shape
    C = W - halo
    dev = windows.device
    lane = torch.arange(B * K, device=dev)
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
        ci = start + t
        bits = windows.view(torch.int16) if windows.dtype == torch.uint16 else windows
        col = bits[b, ci.clamp(max=W - 1)]
        col = col.to(torch.int64) if col.dtype == torch.int32 else _widen(col.view(windows.dtype))
        col = torch.where(ci < W, col, 0)
        lookup = shard_lookup(shard, k, shard.shape[0], shard.shape[1])
        w = lookup(v & ((1 << state_bits) - 1), col)
        words.view(torch.int32).copy_(_to_uint32(w).view(torch.int32))
    elif mode in ("count", "count_packed"):
        total.add_(out.sum())


def group_scan(ranks: Sequence[tuple], windows: torch.Tensor, halo: int, state_bits: int,
               mode: str, reduce: Callable) -> list:
    """The table-sharded scan of ``windows`` as the ranks of a process group
    run it: ``ranks`` holds ``(k, shard)`` of each rank this process drives
    (this process's one rank under a group; every rank where a test
    simulates them), each shard on the windows' device.  Per character one
    ``table_sharded_step`` a rank, then ``reduce(words)``, which must leave
    in each of the ranks' word buffers (``uint32[B * K]``) the sum of every
    rank's: an ``all_reduce(SUM)`` over the model ranks (exact: at most one
    rank's word is not 0).  No host sync inside the loop.  Returns each
    driven rank's result: an int64 scalar tensor (the counts) or the
    ``uint32[1, B * C]`` plane, as ``table_sharded_scan``.  The buffers are
    checked once, before the loop."""
    B, W = windows.shape
    segs = lane_segments(B, W - halo, halo, mode)
    K, L = segs
    dev = windows.device
    counting = mode in ("count", "count_packed")
    lanes = []
    for k, shard in ranks:
        words = torch.zeros(B * K, dtype=torch.uint32, device=dev)
        if counting:
            out = torch.zeros(B * K, dtype=torch.int64, device=dev)
            total = torch.zeros(1, dtype=torch.int64, device=dev)
        else:  # every body position is written once
            out, total = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=dev), None
        _check_step(shard, words, windows, 0, halo, state_bits, mode, segs, out, total)
        lanes.append((k, shard, words, out, total))
    for t in range(halo + L + 1):
        for k, shard, words, out, total in lanes:
            _step(shard, k, words, windows, t, halo, state_bits, mode, segs, out, total)
        if t < halo + L:
            reduce([words for _, _, words, _, _ in lanes])
    return [total[0] if counting else out for _, _, _, out, total in lanes]
