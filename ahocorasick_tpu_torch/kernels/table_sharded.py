"""Row-sharded packed-DFA lane scan: the Hopper kernel and its plain PyTorch
twin.

One kernel (``csrc/table_sharded.cu``) replaces the ``shard_map`` body of
``ahocorasick_tpu/parallel/sharding.py`` ``_table_sharded_build``: the packed
table ``uint32[S, A]`` (``next | payload << state_bits``) is cut into
``n_model`` contiguous row slices of ``rows_per`` rows, and per character the
word of state ``s`` comes from the one shard that owns it
(``k = s // rows_per``).  The JAX body has every device look its own slice up
under a mask and combines the words with a ``psum`` per character; the kernel
reads the owning shard directly through an array of base pointers.

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

The wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _popcount32, _to_uint32, _widen

MODES = ("count", "count_packed", "planes", "hotstate", "raw")
_WINDOW_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


class ShardedTable:
    """The row shards of one packed table: ``n_model`` contiguous
    ``uint32[rows_per, A]`` tensors, shard k holding rows
    ``[k * rows_per, (k + 1) * rows_per)`` (the last one zero-padded), and,
    per scanning CUDA device, the device array of their base pointers."""

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


def _check(table: ShardedTable, windows: torch.Tensor, halo: int, state_bits: int, mode: str):
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
    if table.device_type != windows.device.type:
        raise ValueError(f"shards on {table.device_type}, windows on {windows.device}")
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
               table.rows_per, table.stride, windows.data_ptr(), _WINDOW_BYTES[windows.dtype],
               B, W, halo, state_bits, MODES.index(mode), out.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches["table_sharded_scan"] += 1
    return out[0] if out.dtype == torch.int64 else out


# ----------------------------------------------------------------- plain twin
#
# The JAX body step by step: a Python loop over the W window columns, each a
# masked lookup per shard summed over the shards, on int64 copies of the
# shards and windows (torch has no uint32 shift or popcount).


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


def scan_columns(lookup: Callable, windows: torch.Tensor, halo: int, state_bits: int,
                 mode: str) -> torch.Tensor:
    """The lane scan of the twin over any ``lookup(s, c) -> v`` (int64 lanes):
    the sum over the shards here, one shard and an ``all_reduce`` under a
    process group (``parallel/sharding.py``)."""
    B, W = windows.shape
    smask = (1 << state_bits) - 1
    counting = mode in ("count", "count_packed")
    acc = torch.zeros(B, dtype=torch.int64, device=windows.device)
    out = None if counting else torch.empty((B, W - halo), dtype=torch.int64,
                                            device=windows.device)
    s = torch.zeros(B, dtype=torch.int64, device=windows.device)
    for t in range(W):
        col = windows[:, t]
        v = lookup(s, col.to(torch.int64) if col.dtype == torch.int32 else _widen(col))
        if t >= halo:
            hi = v >> state_bits
            if mode == "count":
                acc.add_(_popcount32(hi))
            elif mode == "count_packed":
                acc.add_(hi)
            elif mode == "planes":
                out[:, t - halo] = hi
            elif mode == "hotstate":
                out[:, t - halo] = torch.where(hi != 0, v, 0)
            else:
                out[:, t - halo] = v
        s = v & smask
    return acc.sum() if counting else _to_uint32(out.reshape(1, -1))


def table_sharded_scan_plain(table: ShardedTable, windows: torch.Tensor, halo: int,
                             state_bits: int, mode: str) -> torch.Tensor:
    dev = windows.device
    lookups = [shard_lookup(t.view(torch.int32).to(dev).view(torch.uint32), k, table.rows_per,
                            table.stride)
               for k, t in enumerate(table.shards)]

    def lookup(s, c):
        v = lookups[0](s, c)
        for fn in lookups[1:]:
            v = v + fn(s, c)
        return v

    return scan_columns(lookup, windows, halo, state_bits, mode)
