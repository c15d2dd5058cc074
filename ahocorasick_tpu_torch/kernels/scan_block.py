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


def _launch(name: str, table, windows, halo, state_bits, out, *lanes) -> None:
    B, W = windows.shape
    dev = windows.device
    build.call(
        name, table.data_ptr(), windows.data_ptr(), _WINDOW_BYTES[windows.dtype],
        B, W, halo, table.shape[1], state_bits, *lanes, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches[name] += 1


# The planes kernel splits windows into segments only while the lanes stay at
# most this many: at the main path's 65,536 windows of 512 body classes one
# lane per window is fastest and more lanes only crowd the SMs' caches, while
# at 8,192 windows or fewer four lanes per window run about 3x faster than
# one (NVIDIA H100 80GB HBM3, 700 W; python -m
# ahocorasick_tpu_torch.bench.planes_stores times both).
MAX_LANES = 65_536
# The count kernel (no store tile) splits windows while the lanes stay at most
# this many.  Its lanes are chains of dependent lookups that wait on L2, so
# more lanes help until the caches' rate binds: K = 1, 2, 4 lanes per window
# ran 0.105, 0.073 / 0.076, 0.093 / 0.095 ms at 65,536 windows of 512 body
# classes, 0.099, 0.058, 0.045 ms at 32,768 and 0.099, 0.055, 0.032 / 0.045
# ms at 8,192 (two runs where they differ); two chains a thread instead of
# two lanes ran slower (0.078 / 0.081 ms at 65,536 windows).  NVIDIA H100
# 80GB HBM3, 700 W; python -m ahocorasick_tpu_torch.bench.scan_variants.
COUNT_MAX_LANES = 131_072


def segments(num_windows: int, body: int, halo: int, max_lanes: int = MAX_LANES) -> tuple:
    """``(K, L)``: a segmented kernel's lanes per window and body positions
    per lane (the last lane of a window takes the rest, ``C - (K-1)*L``).

    K = 4, else 2, else 1: the largest that keeps ``num_windows * K`` within
    ``max_lanes`` (the planes kernels' ``MAX_LANES`` unless a kernel measured
    its own) and whose segments are at least four halos and 32 steps long,
    with L = ceil(C / K) rounded up to a multiple of 4 (16-byte stores) and
    the last segment not empty (C = ``body``).  Each lane is warmed from the
    root over the ``halo`` classes before its segment, which is exact because
    the automaton is ``halo``-synchronizing; with ``halo = 0`` nothing
    synchronizes, so K = 1."""
    if halo >= 1:
        for k in (4, 2):
            seg = -(-body // (4 * k)) * 4
            if (num_windows * k <= max_lanes and seg >= max(4 * halo, 32)
                    and (k - 1) * seg < body):
                return k, seg
    return 1, body


def packed_scan_count(table: torch.Tensor, windows: torch.Tensor, halo: int,
                      state_bits: int) -> torch.Tensor:
    """Total match count over the body positions, as an int64 scalar tensor
    on the windows' device."""
    B, W = _check(table, windows, halo, state_bits)
    if windows.device.type == "cpu":
        return packed_scan_count_plain(table, windows, halo, state_bits)
    out = torch.zeros(1, dtype=torch.int64, device=windows.device)
    _launch("packed_scan_count", table, windows, halo, state_bits, out,
            *segments(B, W - halo, halo, COUNT_MAX_LANES))
    return out[0]


def packed_scan_planes(table: torch.Tensor, windows: torch.Tensor, halo: int,
                       state_bits: int) -> torch.Tensor:
    """END-indexed emit planes ``uint32[1, B*C]`` in flat text order."""
    B, W = _check(table, windows, halo, state_bits)
    if windows.device.type == "cpu":
        return packed_scan_planes_plain(table, windows, halo, state_bits)
    out = torch.empty((1, B * (W - halo)), dtype=torch.uint32, device=windows.device)
    _launch("packed_scan_planes", table, windows, halo, state_bits, out,
            *segments(B, W - halo, halo))
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


def _to_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> uint32, the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(torch.uint32)


def _segment_lanes(windows: torch.Tensor, halo: int, K: int, L: int) -> torch.Tensor:
    """``windows[B, halo + C]`` -> ``lanes[B*K, halo + L]``: lane ``b*K + k``
    holds row b's classes ``[k*L, k*L + halo + L)``, zero past the row."""
    B, W = windows.shape
    if K == 1:
        return windows
    # uint16 has no slicing copy on every build: move the same bits as int16.
    bits = windows.view(torch.int16) if windows.dtype == torch.uint16 else windows
    padded = torch.zeros((B, halo + K * L), dtype=bits.dtype, device=bits.device)
    padded[:, :W] = bits
    lanes = padded.unfold(1, halo + L, L).reshape(B * K, halo + L)
    return lanes.view(windows.dtype) if windows.dtype == torch.uint16 else lanes


def _segmented_count_plain(table_flat, windows, halo, num_classes, smask, K, L, value):
    """The sum of ``value(v)`` (int64) of the entry read at every body
    position, scanned in a segmented kernel's lane decomposition (tile.cuh
    ``count_lane``): K lanes per window, each warmed over the ``halo``
    classes before its segment; a lane's padding past its row counts
    nothing."""
    B, W = windows.shape
    # Body positions each lane holds: L, the last lane of a window the rest.
    limit = (W - halo - torch.arange(K, device=windows.device) * L).clamp(max=L).repeat(B)
    total = torch.zeros(B * K, dtype=torch.int64, device=windows.device)

    def emit(j, v):
        total.add_(torch.where(j < limit, value(v), 0))

    _lane_scan_plain(table_flat, _segment_lanes(windows, halo, K, L), halo, num_classes, smask,
                     emit)
    return total.sum()


def _segmented_planes_plain(table_flat, windows, halo, num_classes, smask, K, L, value,
                            planes: int = 1):
    """``uint32[planes, B*C]`` holding ``value(v)`` (int64 in [0, 2**32):
    ``[lanes]`` for one plane, ``[planes, lanes]`` for more) of the entry
    read at every body position, scanned in a segmented kernel's lane
    decomposition (tile.cuh ``planes_lane``): K lanes per window, each warmed
    over the ``halo`` classes before its segment."""
    B, W = windows.shape
    out = torch.empty((planes, B * K, L), dtype=torch.int64, device=windows.device)

    def emit(j, v):
        out[:, :, j] = value(v)

    _lane_scan_plain(table_flat, _segment_lanes(windows, halo, K, L), halo, num_classes, smask,
                     emit)
    # The last segment's columns past C are padding.
    return _to_uint32(out.reshape(planes, B, K * L)[:, :, : W - halo].reshape(planes, -1))


def packed_scan_count_plain(table, windows, halo, state_bits) -> torch.Tensor:
    """The kernel's lane decomposition (``segments`` under
    ``COUNT_MAX_LANES``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo, COUNT_MAX_LANES)
    return _segmented_count_plain(table.reshape(-1), windows, halo, table.shape[1],
                                  (1 << state_bits) - 1, K, L,
                                  lambda v: _popcount32(v >> state_bits))


def packed_scan_planes_plain(table, windows, halo, state_bits) -> torch.Tensor:
    """The kernel's lane decomposition (``segments``)."""
    B, W = windows.shape
    K, L = segments(B, W - halo, halo)
    return _segmented_planes_plain(table.reshape(-1), windows, halo, table.shape[1],
                                   (1 << state_bits) - 1, K, L, lambda v: v >> state_bits)
