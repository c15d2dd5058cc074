"""Huge-dictionary lane scans: the Hopper kernels and their plain PyTorch
twins.

Four entry points (``csrc/huge_scan.cu``), each named after the JAX device
loop of ``ahocorasick_tpu/ops/scan_batched.py`` it replaces and taking its
arguments in the same order (each runs K lanes per window,
``scan_block.segments`` under a cap of its own below):

* ``packedcount_count(table_flat, windows, halo, state_bits, num_classes)``
  — the sum over every body position of the emit count ``v >> state_bits``
  of the count-packed table ``next | emit_count << state_bits``;
* ``packedcount_hotstate_plane(...)`` — the same scan, ``uint32[1, B*C]``
  holding the whole entry ``v`` where a keyword ends and 0 elsewhere, in
  flat text order (``ops/scan_batched.hotstate_sparse`` decodes it);
* ``split_count(dfa_flat, emit_tab, windows, halo, num_classes,
  num_planes)`` — the bare next state ``dfa_flat[s*A + c]`` (no mask), then
  the popcount of the state's ``num_planes`` emit planes ``emit_tab[s, p]``;
* ``split_emit_planes(...)`` — the same scan, ``uint32[P, B*C]`` holding
  plane p of the arrival state's emit mask (plane-major).

Inputs follow the windows contract of ``ops/scan_batched.chunk_classes``:
``windows`` is ``uint8`` or ``uint16[B, halo + C]`` class ids; the tables are
flat and unpadded, as ``ops/scan_batched.build_count_packed`` and
``build_packed`` give them (row stride ``num_classes``).

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import (
    COUNT_MAX_LANES,
    MAX_LANES,
    _WINDOW_BYTES,
    _check_windows,
    _popcount32,
    _segmented_count_plain,
    _segmented_planes_plain,
    _widen,
    segments,
)


def _check_count_packed(table_flat, windows, halo, state_bits, num_classes):
    if table_flat.dtype != torch.uint32 or table_flat.dim() != 1:
        raise TypeError(
            f"table must be flat uint32[S*A], got {table_flat.dtype}{tuple(table_flat.shape)}")
    if num_classes < 1 or table_flat.numel() % num_classes:
        raise ValueError(f"table of {table_flat.numel()} entries is not S x {num_classes}")
    states = table_flat.numel() // num_classes
    if not 1 <= state_bits <= 31 or states > (1 << state_bits):
        raise ValueError(f"state_bits={state_bits} cannot address {states} states")
    return _check_windows(windows, halo, table_flat)


def _check_split(dfa_flat, emit_tab, windows, halo, num_classes, num_planes):
    if dfa_flat.dtype != torch.uint32 or dfa_flat.dim() != 1:
        raise TypeError(
            f"dfa_flat must be uint32[S*A], got {dfa_flat.dtype}{tuple(dfa_flat.shape)}")
    if emit_tab.dtype != torch.uint32 or emit_tab.dim() != 2 or emit_tab.shape[1] != num_planes:
        raise TypeError(
            f"emit_tab must be uint32[S, {num_planes}], got {emit_tab.dtype}{tuple(emit_tab.shape)}")
    if num_classes < 1 or dfa_flat.numel() != emit_tab.shape[0] * num_classes:
        raise ValueError(
            f"dfa_flat of {dfa_flat.numel()} entries is not {emit_tab.shape[0]} x {num_classes}")
    return _check_windows(windows, halo, dfa_flat, emit_tab)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# The count-packed count's cap on lanes (``scan_block.segments``): the count
# lane's, as for the packed count.  On the 1M dictionary's 470 MB count-packed
# table, K = 1, 2, 4 lanes per window ran 0.374 / 0.370, 0.369 / 0.365,
# 0.414 / 0.405 ms at 65,536 windows of 512 body classes (two runs: K = 2
# ahead by about 1.5% in both), 0.247 / 0.246, 0.193 / 0.191, 0.203 / 0.192
# ms at 32,768 and 0.246 / 0.244, 0.126 / 0.125, 0.069 / 0.069 ms at 8,192;
# one lane per window with byte loads, the kernel's first form, 0.403 /
# 0.400 ms at 65,536 (NVIDIA H100 80GB HBM3, 700 W; python -m
# ahocorasick_tpu_torch.bench.scan_variants).
PACKEDCOUNT_MAX_LANES = COUNT_MAX_LANES


def packedcount_count(table_flat: torch.Tensor, windows: torch.Tensor, halo: int,
                      state_bits: int, num_classes: int) -> torch.Tensor:
    """Total emit count over the body positions, as an int64 scalar tensor
    on the windows' device."""
    B, W = _check_count_packed(table_flat, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return packedcount_count_plain(table_flat, windows, halo, state_bits, num_classes)
    dev = windows.device
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    build.call("packedcount_count", table_flat.data_ptr(), windows.data_ptr(),
               _WINDOW_BYTES[windows.dtype], B, W, halo, num_classes, state_bits,
               *segments(B, W - halo, halo, PACKEDCOUNT_MAX_LANES), out.data_ptr(), dev.index,
               _stream(dev))
    launches["packedcount_count"] += 1
    return out[0]


# The hotstate kernel's cap on lanes (``scan_block.segments``): the planes
# kernel's.  On the 1M dictionary's 470 MB count-packed table, K = 1, 2, 4
# lanes per window ran 0.427 / 0.423, 0.418 / 0.428, 0.463 / 0.457 ms at
# 65,536 windows of 512 body classes (two runs: K = 1 and 2 tie), 0.294,
# 0.220, 0.223 / 0.226 ms at 32,768 and 0.274, 0.146, 0.082 ms at 8,192
# (NVIDIA H100 80GB HBM3, 700 W; python -m
# ahocorasick_tpu_torch.bench.scan_variants), so the best K at each is the
# one that keeps the lanes within 65,536.
HOTSTATE_MAX_LANES = MAX_LANES


def packedcount_hotstate_plane(table_flat: torch.Tensor, windows: torch.Tensor, halo: int,
                               state_bits: int, num_classes: int) -> torch.Tensor:
    """``uint32[1, B*C]``: the packed entry where a keyword ends, else 0."""
    B, W = _check_count_packed(table_flat, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return packedcount_hotstate_plane_plain(table_flat, windows, halo, state_bits,
                                                num_classes)
    dev = windows.device
    out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=dev)
    build.call("packedcount_hotstate_plane", table_flat.data_ptr(), windows.data_ptr(),
               _WINDOW_BYTES[windows.dtype], B, W, halo, num_classes, state_bits,
               *segments(B, W - halo, halo, HOTSTATE_MAX_LANES), out.data_ptr(), dev.index,
               _stream(dev))
    launches["packedcount_hotstate_plane"] += 1
    return out


# The split count's cap on lanes (``scan_block.segments``): the planes
# kernels', not the other counts'.  On the 1M dictionary's split tables (P =
# 1), K = 1, 2, 4 lanes per window ran 0.484, 0.500, 0.522 ms at 65,536
# windows of 512 body classes, 0.283, 0.256, 0.270 ms at 32,768 and 0.281,
# 0.146, 0.089 ms at 8,192; the kernel's first form (one lane per window,
# byte loads, the emit loads in the chain) 0.571 ms at 65,536 (NVIDIA H100
# 80GB HBM3, 700 W; python -m ahocorasick_tpu_torch.bench.scan_variants).
SPLIT_COUNT_MAX_LANES = MAX_LANES


def split_count(dfa_flat: torch.Tensor, emit_tab: torch.Tensor, windows: torch.Tensor,
                halo: int, num_classes: int, num_planes: int) -> torch.Tensor:
    """Total match count (emit-plane popcounts) over the body positions, as
    an int64 scalar tensor on the windows' device."""
    B, W = _check_split(dfa_flat, emit_tab, windows, halo, num_classes, num_planes)
    if windows.device.type == "cpu":
        return split_count_plain(dfa_flat, emit_tab, windows, halo, num_classes, num_planes)
    dev = windows.device
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    build.call("split_count", dfa_flat.data_ptr(), emit_tab.data_ptr(), windows.data_ptr(),
               _WINDOW_BYTES[windows.dtype], B, W, halo, num_classes, num_planes,
               *segments(B, W - halo, halo, SPLIT_COUNT_MAX_LANES), out.data_ptr(), dev.index,
               _stream(dev))
    launches["split_count"] += 1
    return out[0]


# The split planes' cap on lanes (``scan_block.segments``): the planes
# kernel's.  On the 1M dictionary's split tables (P = 1), K = 1, 2, 4 lanes
# per window ran 0.556 / 0.548, 0.618 / 0.611, 0.663 / 0.661 ms at 65,536
# windows of 512 body classes (two runs), 0.361 / 0.359, 0.299 / 0.293, 0.336
# / 0.331 ms at 32,768 and 0.341 / 0.338, 0.182 / 0.181, 0.104 / 0.104 ms at
# 8,192; the kernel's first form (one lane per window, byte loads, the emit
# load in the chain, 4-byte row stores) 1.150 / 1.086 ms at 65,536 (NVIDIA
# H100 80GB HBM3, 700 W; python -m ahocorasick_tpu_torch.bench.scan_variants).
SPLIT_PLANES_MAX_LANES = MAX_LANES


def split_emit_planes(dfa_flat: torch.Tensor, emit_tab: torch.Tensor, windows: torch.Tensor,
                      halo: int, num_classes: int, num_planes: int) -> torch.Tensor:
    """END-indexed emit planes ``uint32[P, B*C]``, plane-major."""
    B, W = _check_split(dfa_flat, emit_tab, windows, halo, num_classes, num_planes)
    if windows.device.type == "cpu":
        return split_emit_planes_plain(dfa_flat, emit_tab, windows, halo, num_classes,
                                       num_planes)
    dev = windows.device
    out = torch.empty((num_planes, B * (W - halo)), dtype=torch.uint32, device=dev)
    build.call("split_emit_planes", dfa_flat.data_ptr(), emit_tab.data_ptr(),
               windows.data_ptr(), _WINDOW_BYTES[windows.dtype], B, W, halo, num_classes,
               num_planes, *segments(B, W - halo, halo, SPLIT_PLANES_MAX_LANES),
               out.data_ptr(), dev.index, _stream(dev))
    launches["split_emit_planes"] += 1
    return out


# ---------------------------------------------------------------- plain twins
#
# The algorithm of the JAX loops: a Python loop over the W window columns
# with one batched gather over the B lanes, on int64 copies of the tables
# and windows (torch has no uint32 shift or popcount).


def packedcount_count_plain(table_flat, windows, halo, state_bits, num_classes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``PACKEDCOUNT_MAX_LANES``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, PACKEDCOUNT_MAX_LANES)
    return _segmented_count_plain(table_flat, windows, halo, num_classes,
                                  (1 << state_bits) - 1, K, L, lambda v: v >> state_bits)


def packedcount_hotstate_plane_plain(table_flat, windows, halo, state_bits,
                                     num_classes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``HOTSTATE_MAX_LANES``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, HOTSTATE_MAX_LANES)
    return _segmented_planes_plain(table_flat, windows, halo, num_classes,
                                   (1 << state_bits) - 1, K, L,
                                   lambda v: torch.where((v >> state_bits) != 0, v, 0))


def split_count_plain(dfa_flat, emit_tab, windows, halo, num_classes,
                      num_planes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``SPLIT_COUNT_MAX_LANES``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, SPLIT_COUNT_MAX_LANES)
    et = _widen(emit_tab)
    return _segmented_count_plain(dfa_flat, windows, halo, num_classes, 0xFFFFFFFF, K, L,
                                  lambda s: _popcount32(et[s]).sum(1))


def split_emit_planes_plain(dfa_flat, emit_tab, windows, halo, num_classes,
                            num_planes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``SPLIT_PLANES_MAX_LANES``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, SPLIT_PLANES_MAX_LANES)
    et = _widen(emit_tab.reshape(-1))
    p = torch.arange(num_planes, device=windows.device)[:, None]
    return _segmented_planes_plain(dfa_flat, windows, halo, num_classes, 0xFFFFFFFF, K, L,
                                   lambda s: et[s[None, :] * num_planes + p], num_planes)
