"""Stride-2 row-DFA lane scan: the Hopper kernels and their plain PyTorch
twins.

Two entry points (``csrc/rowdfa2_scan.cu``), replacing the JAX package's
``ahocorasick_tpu/ops/scan_rowdfa.py`` ``rowdfa_count`` / ``rowdfa_emit_planes``
and taking their arguments in the same order:

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
    _WINDOW_BYTES,
    _check_windows,
    _popcount32,
    _widen,
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


def _launch(name: str, table, windows, halo, state_bits, num_classes, out) -> None:
    B, W = windows.shape
    dev = windows.device
    build.call(
        name, table.data_ptr(), windows.data_ptr(), _WINDOW_BYTES[windows.dtype],
        B, W, halo, num_classes, state_bits, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches[name] += 1


def rowdfa2_count(table: torch.Tensor, windows: torch.Tensor, halo: int, state_bits: int,
                  num_classes: int) -> torch.Tensor:
    """Total match count over the body positions, as an int64 scalar tensor
    on the windows' device."""
    _check(table, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return rowdfa_count_plain(table, windows, halo, state_bits, num_classes)
    out = torch.zeros(1, dtype=torch.int64, device=windows.device)
    _launch("rowdfa2_count", table, windows, halo, state_bits, num_classes, out)
    return out[0]


def rowdfa2_planes(table: torch.Tensor, windows: torch.Tensor, halo: int, state_bits: int,
                   num_classes: int) -> torch.Tensor:
    """END-indexed emit planes ``uint32[1, B*C]`` in flat text order."""
    B, W = _check(table, windows, halo, state_bits, num_classes)
    if windows.device.type == "cpu":
        return rowdfa_emit_planes_plain(table, windows, halo, state_bits, num_classes)
    out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=windows.device)
    _launch("rowdfa2_planes", table, windows, halo, state_bits, num_classes, out)
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
    pop = torch.zeros(windows.shape[0], dtype=torch.int64, device=windows.device)

    def emit(_t, e1, e2):
        pop.add_(_popcount32(e1) + _popcount32(e2))

    _pair_scan_plain(table, windows, halo, state_bits, num_classes, emit)
    return pop.sum()


def rowdfa_emit_planes_plain(table, windows, halo, state_bits, num_classes) -> torch.Tensor:
    B, W = windows.shape
    out = torch.empty((B, (W - halo) // 2, 2), dtype=torch.int64, device=windows.device)

    def emit(t, e1, e2):
        out[:, t, 0] = e1
        out[:, t, 1] = e2

    _pair_scan_plain(table, windows, halo, state_bits, num_classes, emit)
    # Emit masks are < 2**31 (state_bits >= 1), so int32 holds them exactly.
    return out.reshape(1, -1).to(torch.int32).view(torch.uint32)
