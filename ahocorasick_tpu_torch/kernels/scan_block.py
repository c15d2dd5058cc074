"""Packed-DFA lane scan: the Hopper kernels and their plain PyTorch twins.

One kernel family with two entry points (``csrc/packed_scan.cu``):

* ``packed_scan_count`` — total match count, the sum over every body
  position of ``popcount(v >> state_bits)``;
* ``packed_scan_planes`` — END-indexed emit planes ``uint32[1, B*C]`` in
  flat text order (bit L-1 at position j: a keyword of length L ends at j).

They replace the TPU's Pallas kernels ``ahocorasick_tpu/kernels/scan_block.py``
``block_count`` / ``block_emit_planes`` and the XLA lane scans
``scan_rowdfa.rowdfa1_*`` / ``scan_batched.batched_*``, which all compute these
two results over the packed table ``next | emit << state_bits``.  The source
note in the ``.cu`` file says what bounds the kernel on the H100.

Inputs follow the windows contract of ``ops/scan_batched.chunk_classes``:
``windows`` is ``uint8`` or ``uint16[B, halo + C]`` class ids, ``table`` is
``uint32[S, A]`` (A = padded class count, the row stride).

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches

_WINDOW_BYTES = {torch.uint8: 1, torch.uint16: 2}


def _check_windows(windows: torch.Tensor, halo: int, *tables: torch.Tensor):
    """Checks ``chunk_classes`` windows and that the tables lie beside them;
    returns ``(B, W)``."""
    if windows.dtype not in _WINDOW_BYTES or windows.dim() != 2:
        raise TypeError(
            f"windows must be uint8 or uint16[B, W], got {windows.dtype}{tuple(windows.shape)}")
    for t in tables:
        if t.device != windows.device:
            raise ValueError(f"table on {t.device}, windows on {windows.device}")
    if not all(t.is_contiguous() for t in (windows, *tables)):
        raise ValueError("tables and windows must be contiguous")
    B, W = windows.shape
    if B < 1 or not 0 <= halo < W:
        raise ValueError(f"need B >= 1 and 0 <= halo < W; got B={B}, W={W}, halo={halo}")
    if windows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {windows.device}")
    return B, W


def _check(table: torch.Tensor, windows: torch.Tensor, halo: int, state_bits: int):
    if table.dtype != torch.uint32 or table.dim() != 2:
        raise TypeError(f"table must be uint32[S, A], got {table.dtype}{tuple(table.shape)}")
    if not 1 <= state_bits <= 31 or table.shape[0] > (1 << state_bits):
        raise ValueError(f"state_bits={state_bits} cannot address {table.shape[0]} states")
    return _check_windows(windows, halo, table)


def _launch(name: str, table, windows, halo, state_bits, out) -> None:
    B, W = windows.shape
    dev = windows.device
    build.call(
        name, table.data_ptr(), windows.data_ptr(), _WINDOW_BYTES[windows.dtype],
        B, W, halo, table.shape[1], state_bits, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches[name] += 1


def packed_scan_count(table: torch.Tensor, windows: torch.Tensor, halo: int,
                      state_bits: int) -> torch.Tensor:
    """Total match count over the body positions, as an int64 scalar tensor
    on the windows' device."""
    _check(table, windows, halo, state_bits)
    if windows.device.type == "cpu":
        return packed_scan_count_plain(table, windows, halo, state_bits)
    out = torch.zeros(1, dtype=torch.int64, device=windows.device)
    _launch("packed_scan_count", table, windows, halo, state_bits, out)
    return out[0]


def packed_scan_planes(table: torch.Tensor, windows: torch.Tensor, halo: int,
                       state_bits: int) -> torch.Tensor:
    """END-indexed emit planes ``uint32[1, B*C]`` in flat text order."""
    B, W = _check(table, windows, halo, state_bits)
    if windows.device.type == "cpu":
        return packed_scan_planes_plain(table, windows, halo, state_bits)
    out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=windows.device)
    _launch("packed_scan_planes", table, windows, halo, state_bits, out)
    return out


# ---------------------------------------------------------------- plain twins
#
# The same algorithm as ``batched_count`` / ``batched_emit_planes``: a Python
# loop over the W window columns with one batched gather over the B lanes.
# torch has no shift or nonzero for uint32 and no popcount, so the twins
# widen the table and the windows to int64 (reading the bits through
# same-width signed views) and count bits with SWAR arithmetic.


def _widen(t: torch.Tensor) -> torch.Tensor:
    signed = {torch.uint8: torch.uint8, torch.uint16: torch.int16, torch.uint32: torch.int32}
    bits = 8 * t.element_size()
    return t.view(signed[t.dtype]).to(torch.int64) & ((1 << bits) - 1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _lane_scan_plain(table_flat, windows, halo, num_classes, smask, emit):
    """The lane scan of every twin: entry ``v = table_flat[s * num_classes +
    c]`` per column, ``emit(j, v)`` at body column j, next state
    ``v & smask``."""
    tf = _widen(table_flat)
    s = torch.zeros(windows.shape[0], dtype=torch.int64, device=windows.device)
    for t in range(windows.shape[1]):
        v = tf[s * num_classes + _widen(windows[:, t])]
        if t >= halo:
            emit(t - halo, v)
        s = v & smask


def _scan_plain(table, windows, halo, state_bits, emit):
    _lane_scan_plain(table.reshape(-1), windows, halo, table.shape[1], (1 << state_bits) - 1,
                     lambda j, v: emit(j, v >> state_bits))


def packed_scan_count_plain(table, windows, halo, state_bits) -> torch.Tensor:
    pop = torch.zeros(windows.shape[0], dtype=torch.int64, device=windows.device)

    def emit(_j, e):
        pop.add_(_popcount32(e))

    _scan_plain(table, windows, halo, state_bits, emit)
    return pop.sum()


def packed_scan_planes_plain(table, windows, halo, state_bits) -> torch.Tensor:
    B, W = windows.shape
    out = torch.empty((B, W - halo), dtype=torch.int64, device=windows.device)

    def emit(j, e):
        out[:, j] = e

    _scan_plain(table, windows, halo, state_bits, emit)
    # Emit masks are < 2**31 (state_bits >= 1), so int32 holds them exactly.
    return out.reshape(1, -1).to(torch.int32).view(torch.uint32)
