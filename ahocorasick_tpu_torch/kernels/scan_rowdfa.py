"""Stride-2 row-DFA lane scan: the Hopper kernels and their plain PyTorch
twins.

Two entry points (``csrc/rowdfa2_scan.cu``: ``tile.cuh``'s lane loops over
its stride-2 table type), replacing the JAX package's
``ahocorasick_tpu/ops/scan_rowdfa.py`` ``rowdfa_count`` / ``rowdfa_emit_planes``
and taking their arguments in the same order, each K lanes per window
(``scan_block.segments`` under a cap of its own below):

* ``rowdfa2_count(table, windows, halo, state_bits, num_classes)`` — total
  match count, ``popcount(emit1) + popcount(emit2)`` summed over the body's
  pairs;
* ``rowdfa2_planes(...)`` — END-indexed emit planes ``uint32[1, B*C]`` in flat
  text order, the layout of ``scan_block.packed_scan_planes``.

``table`` is ``ops/scan_rowdfa.build_rowdfa``'s ``uint32[S*A, A+1]``; inputs
follow the windows contract of ``ops/scan_batched.chunk_classes`` (``uint8``
or ``uint16[B, halo + C]`` class ids), with an even halo and an even C.  The
source note in the ``.cu`` file says what bounds the kernel on the H100.

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
    _WINDOW_BYTES,
    _check_windows,
    _popcount32,
    _segment_lanes,
    _widen,
    segments,
)


def _check(table, windows, halo, state_bits, num_classes):
    if table.dtype != torch.uint32 or table.dim() != 2:
        raise TypeError(f"table must be uint32[S*A, A+1], got {table.dtype}{tuple(table.shape)}")
    if num_classes < 1 or table.shape[1] != num_classes + 1 or table.shape[0] % num_classes:
        raise ValueError(f"table {tuple(table.shape)} is not [S*{num_classes}, {num_classes + 1}]")
    states = table.shape[0] // num_classes
    if not 1 <= state_bits <= 31 or states > (1 << state_bits):
        raise ValueError(f"state_bits={state_bits} cannot address {states} states")
    B, W = _check_windows(windows, halo, table)
    if halo % 2 or (W - halo) % 2:
        raise ValueError(f"the stride-2 scan needs an even halo and body, got halo={halo}, W={W}")
    return B, W


def _launch(name: str, table, windows, halo, state_bits, num_classes, out, cap) -> None:
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, cap)
    # Every segment starts on a pair of the one-lane scan and holds whole pairs.
    assert halo % 2 == 0 and L % 2 == 0 and (W - halo - (K - 1) * L) % 2 == 0
    dev = windows.device
    build.call(
        name, table.data_ptr(), windows.data_ptr(), _WINDOW_BYTES[windows.dtype],
        B, W, halo, num_classes, state_bits, K, L, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches[name] += 1


# The stride-2 count splits windows into K lanes while B*K stays within this
# many, as the packed count does (its lanes wait on the table each step, so
# shorter chains win until the caches' rate binds).  On the 10k dictionary's
# 152 MB table K = 1, 2, 4 lanes per window ran 0.1505, 0.1462, 0.1752 ms at
# 65,536 windows of 512 body classes, 0.0800, 0.0795, 0.0773 ms at 32,768
# and 0.0704, 0.0384, 0.0254 ms at 8,192 (the first design, one lane per
# window with a class load a step: 0.1965, 0.0865, 0.0705 ms).  NVIDIA H100
# 80GB HBM3, 700 W; python -m ahocorasick_tpu_torch.bench.scan_variants
# (rowdfa2_ab).
ROWDFA2_COUNT_MAX_LANES = COUNT_MAX_LANES


def rowdfa2_count(table: torch.Tensor, windows: torch.Tensor, halo: int, state_bits: int,
                  num_classes: int) -> torch.Tensor:
    """Total match count over the body positions, as an int64 scalar tensor
    on the windows' device."""
    _check(table, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return rowdfa_count_plain(table, windows, halo, state_bits, num_classes)
    out = torch.zeros(1, dtype=torch.int64, device=windows.device)
    _launch("rowdfa2_count", table, windows, halo, state_bits, num_classes, out,
            ROWDFA2_COUNT_MAX_LANES)
    return out[0]


# The stride-2 planes split windows into K lanes while B*K stays within this
# many, half the other planes kernels' cap.  On the 10k dictionary's 152 MB
# table K = 1, 2, 4 lanes per window ran 0.291, 0.299, 0.342 ms at 65,536
# windows of 512 body classes, 0.145, 0.150, 0.154 ms at 32,768 and 0.084,
# 0.046, 0.039 ms at 8,192 (the first design, one lane per window with a
# class load a step and 8-byte stores at the lane's own row: 0.504, 0.219,
# 0.133 ms).  NVIDIA H100 80GB HBM3, 700 W; python -m
# ahocorasick_tpu_torch.bench.scan_variants (rowdfa2_ab).
ROWDFA2_PLANES_MAX_LANES = 32_768


def rowdfa2_planes(table: torch.Tensor, windows: torch.Tensor, halo: int, state_bits: int,
                   num_classes: int) -> torch.Tensor:
    """END-indexed emit planes ``uint32[1, B*C]`` in flat text order."""
    B, W = _check(table, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return rowdfa_emit_planes_plain(table, windows, halo, state_bits, num_classes)
    out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=windows.device)
    _launch("rowdfa2_planes", table, windows, halo, state_bits, num_classes, out,
            ROWDFA2_PLANES_MAX_LANES)
    return out


# ---------------------------------------------------------------- plain twins
#
# The algorithm of the JAX scans: a Python loop over the window's column
# pairs with one batched lookup of the row's c1 column and one of its emit1
# column over the B lanes, on int64 copies of the table and windows.


def _pair_scan_plain(table, windows, halo, state_bits, num_classes, emit):
    """``emit(t, e1, e2)`` at body pair t (positions 2t and 2t + 1)."""
    A = num_classes
    tf = _widen(table.reshape(-1))
    smask = (1 << state_bits) - 1
    s = torch.zeros(windows.shape[0], dtype=torch.int64, device=windows.device)
    for t in range(0, windows.shape[1], 2):
        base = (s * A + _widen(windows[:, t])) * (A + 1)
        w = tf[base + _widen(windows[:, t + 1])]
        if t >= halo:
            emit((t - halo) // 2, tf[base + A], w >> state_bits)
        s = w & smask


def rowdfa_count_plain(table, windows, halo, state_bits, num_classes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``ROWDFA2_COUNT_MAX_LANES``): K lanes per window, each warmed over the
    halo before its segment; a lane's padding past its row counts
    nothing."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, ROWDFA2_COUNT_MAX_LANES)
    # Body positions each lane holds: L, the last lane of a window the rest.
    limit = (W - halo - torch.arange(K, device=windows.device) * L).clamp(max=L).repeat(B)
    pop = torch.zeros(B * K, dtype=torch.int64, device=windows.device)

    def emit(t, e1, e2):
        pop.add_(torch.where(2 * t < limit, _popcount32(e1) + _popcount32(e2), 0))

    _pair_scan_plain(table, _segment_lanes(windows, halo, K, L), halo, state_bits, num_classes,
                     emit)
    return pop.sum()


def rowdfa_emit_planes_plain(table, windows, halo, state_bits, num_classes) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``ROWDFA2_PLANES_MAX_LANES``): K lanes per window, each warmed over the
    halo before its segment; the last lane's columns past the row are
    padding."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, ROWDFA2_PLANES_MAX_LANES)
    out = torch.empty((B * K, L // 2, 2), dtype=torch.int64, device=windows.device)

    def emit(t, e1, e2):
        out[:, t, 0] = e1
        out[:, t, 1] = e2

    _pair_scan_plain(table, _segment_lanes(windows, halo, K, L), halo, state_bits, num_classes,
                     emit)
    # Emit masks are < 2**31 (state_bits >= 1), so int32 holds them exactly.
    planes = out.reshape(B, K * L)[:, : W - halo]
    return planes.reshape(1, -1).to(torch.int32).view(torch.uint32)
