"""Sequential DFA scans: the Hopper kernels and their plain PyTorch twins.

``seq_states(table, row_id, cls, s0, sync_depth)`` returns the arrival
states ``int32[N]`` of ``s = table[s, c]`` from the entry state ``s0``, over a
dense ``int32[S, A]`` table (``row_id=None``) or a row-deduplicated one
(``s = rows[row_id[s], c]``: ``table`` is ``rows int32[R, A]``, ``row_id``
``int32[S]``), with ``int32[N]`` classes; the carry to the next feed is
``states[-1]``.  ``sync_depth=None`` walks the chain serially, the only
correct form for a table that does not synchronize (the shortest matcher's
restart table); ``sync_depth=d`` declares the table d-synchronizing (a goto
closure, d = ``max(max_depth, 1)``) and runs the lane scan: lanes of
``sync_lane_len(N, d)`` positions, lane 0 from ``s0``, every other lane from
the root warmed over the d classes before it.  Both give the same states.
The kernels (``csrc/seq_scan.cu``) replace the JAX package's
``core/stream.py`` ``_seqscan_jit`` runner (both table forms) and
``ops/scan_dfa.py`` ``dfa_states`` (the dense form).

``shortest_states(dfa_next, match_len, cls)`` returns the arrival states
``int32[N]`` of ``s = dfa_next[match_len[s] > 0 ? 0 : s, c]`` from the root,
over tables padded as the JAX package pads them (``dfa_next`` int32[S_pad,
A_pad], ``match_len`` int32[S_pad]) and classes ``uint8``, ``uint16`` or
``int32[N]``.

That kernel (``csrc/shortest_scan.cu``) replaces the JAX package's
``ops/scan_dfa.py`` ``shortest_states`` (one ``lax.scan``).  Its restart
recurrence does not synchronize, so it is one thread walking the chain, as
is the serial ``seq_states``; the source notes say what that costs.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches["seq_states"]`` (the lane scan),
``launches["seq_states_serial"]`` (the serial walk) and
``launches["shortest_states"]`` count kernel launches only;
``build.seq_units`` adds up the units the first two scanned.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches, seq_units
from ahocorasick_tpu_torch.kernels.scan_block import _widen

_CLASS_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _check(dfa_next: torch.Tensor, match_len: torch.Tensor, cls: torch.Tensor):
    if dfa_next.dtype != torch.int32 or dfa_next.dim() != 2:
        raise TypeError(f"dfa_next must be int32[S, A], got {dfa_next.dtype}{tuple(dfa_next.shape)}")
    if match_len.dtype != torch.int32 or match_len.shape != dfa_next.shape[:1]:
        raise TypeError(
            f"match_len must be int32[{dfa_next.shape[0]}], got "
            f"{match_len.dtype}{tuple(match_len.shape)}")
    if cls.dtype not in _CLASS_BYTES or cls.dim() != 1:
        raise TypeError(f"classes must be uint8, uint16 or int32[N], got {cls.dtype}{tuple(cls.shape)}")
    if not dfa_next.device == match_len.device == cls.device:
        raise ValueError(
            f"dfa_next on {dfa_next.device}, match_len on {match_len.device}, "
            f"classes on {cls.device}")
    if not (dfa_next.is_contiguous() and match_len.is_contiguous() and cls.is_contiguous()):
        raise ValueError("tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cls.device}")


def shortest_states(dfa_next: torch.Tensor, match_len: torch.Tensor,
                    cls: torch.Tensor) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the shortest matcher's restart loop."""
    _check(dfa_next, match_len, cls)
    if cls.device.type == "cpu":
        return shortest_states_plain(dfa_next, match_len, cls)
    dev = cls.device
    out = torch.empty(cls.shape[0], dtype=torch.int32, device=dev)
    if cls.shape[0] == 0:
        return out
    build.call(
        "shortest_states", dfa_next.data_ptr(), match_len.data_ptr(), cls.data_ptr(),
        _CLASS_BYTES[cls.dtype], cls.shape[0], dfa_next.shape[1], out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches["shortest_states"] += 1
    return out


def shortest_states_plain(dfa_next, match_len, cls) -> torch.Tensor:
    """The plain twin: a Python loop of torch indexing, one step per class."""
    flat = dfa_next.reshape(-1).to(torch.int64)
    A = dfa_next.shape[1]
    c = cls.to(torch.int64) if cls.dtype == torch.int32 else _widen(cls)
    out = torch.empty(cls.shape[0], dtype=torch.int64, device=cls.device)
    s = torch.zeros((), dtype=torch.int64, device=cls.device)
    for i in range(cls.shape[0]):
        row = torch.where(match_len[s] > 0, 0, s)
        s = flat[row * A + c[i]]
        out[i] = s
    return out.to(torch.int32)


def _check_seq(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int):
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table must be int32[S, A], got {table.dtype}{tuple(table.shape)}")
    if row_id is not None and (row_id.dtype != torch.int32 or row_id.dim() != 1):
        raise TypeError(f"row_id must be int32[S], got {row_id.dtype}{tuple(row_id.shape)}")
    if cls.dtype != torch.int32 or cls.dim() != 1:
        raise TypeError(f"classes must be int32[N], got {cls.dtype}{tuple(cls.shape)}")
    tensors = [t for t in (table, row_id, cls) if t is not None]
    if any(t.device != cls.device for t in tensors):
        raise ValueError("table, row_id and classes must lie on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cls.device}")
    states = table.shape[0] if row_id is None else row_id.shape[0]
    if not 0 <= s0 < states:
        raise ValueError(f"entry state {s0} outside [0, {states})")


# The lane scan runs at most this many lanes: a feed of N units takes lanes of
# max(d, N / SEQ_MAX_LANES) positions, rounded up to a multiple of 4 (16-byte
# stores).  Short feeds thus get the shortest chains the depth allows, and
# 32 Mi units lanes of 16.  On 32 Mi units lanes of 12, 16, 64, 256 and 1,024
# ran 0.260, 0.267, 0.313, 0.265 and 0.361 ms on the 10k dense table (d =
# 12), and lanes of 4, 16, 64, 256 and 1,024 ran 0.223, 0.134, 0.220, 0.208
# and 0.340 ms on the 55,040-class RowTable (d = 1); on 64 Ki units lanes of
# d ran fastest on both (0.0101 and 0.0066 ms).  NVIDIA H100 80GB HBM3,
# 700 W; python -m ahocorasick_tpu_torch.bench.scan_variants (seq_ab).
SEQ_MAX_LANES = 1 << 21


def sync_lane_len(n: int, depth: int) -> int:
    """The lane scan's positions per lane, ``L >= depth``, for ``n`` units."""
    L = max(depth, -(-n // SEQ_MAX_LANES), 1)
    return -(-L // 4) * 4


def seq_states(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int = 0,
               sync_depth=None) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the scan from ``s0``; ``row_id`` None
    for a dense table, else the state -> row map of a row-deduplicated one;
    ``sync_depth`` None for the serial walk, else the depth d >= 1 at which
    the table synchronizes (the lane scan)."""
    s0 = int(s0)
    _check_seq(table, row_id, cls, s0)
    if sync_depth is not None:
        sync_depth = int(sync_depth)
        if sync_depth < 1:
            raise ValueError(f"sync_depth must be >= 1, got {sync_depth}")
    if cls.device.type == "cpu":
        return seq_states_plain(table, row_id, cls, s0, sync_depth)
    dev = cls.device
    n = cls.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rid = None if row_id is None else row_id.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if sync_depth is None:
        build.call("seq_states", table.data_ptr(), rid, cls.data_ptr(), n, table.shape[1], s0,
                   out.data_ptr(), dev.index, stream)
        name = "seq_states_serial"
    else:
        build.call("seq_states_sync", table.data_ptr(), rid, cls.data_ptr(), n, table.shape[1],
                   s0, sync_depth, sync_lane_len(n, sync_depth), out.data_ptr(), dev.index,
                   stream)
        name = "seq_states"
    launches[name] += 1
    seq_units[name] += n
    return out


def seq_states_plain(table, row_id, cls, s0: int = 0, sync_depth=None) -> torch.Tensor:
    """The plain twin.  Serial (``sync_depth`` None): a Python loop of
    ``table[s, c]`` (``rows[row_id[s], c]``), one indexing step per class.
    Synchronized: the kernel's decomposition, every lane stepped together,
    one batched indexing step per warm-up class and per position of a
    segment."""
    if sync_depth is not None:
        return _sync_states_plain(table, row_id, cls, s0, sync_depth)
    flat = table.reshape(-1)
    A = table.shape[1]
    s = int(s0)
    out = []
    for c in cls.tolist():
        row = s if row_id is None else int(row_id[s])
        s = int(flat[row * A + c])
        out.append(s)
    return torch.tensor(out, dtype=torch.int32, device=cls.device)


def _sync_states_plain(table, row_id, cls, s0: int, depth: int) -> torch.Tensor:
    n = cls.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=cls.device)
    L = sync_lane_len(n, depth)
    lanes = -(-n // L)
    flat = table.reshape(-1).to(torch.int64)
    rid = None if row_id is None else row_id.to(torch.int64)
    A = table.shape[1]
    c = torch.zeros(lanes * L, dtype=torch.int64, device=cls.device)
    c[:n] = cls.to(torch.int64)

    def step(s, col):
        return flat[(s if rid is None else rid[s]) * A + col]

    s = torch.zeros(lanes, dtype=torch.int64, device=cls.device)
    s[0] = s0
    starts = torch.arange(1, lanes, device=cls.device) * L
    for t in range(depth):  # lanes 1.. warm up over the d classes before them
        s[1:] = step(s[1:], c[starts - depth + t])
    out = torch.empty((lanes, L), dtype=torch.int64, device=cls.device)
    body = c.reshape(lanes, L)
    for t in range(L):  # the last lane's steps past n read class 0 and are cut
        s = step(s, body[:, t])
        out[:, t] = s
    return out.reshape(-1)[:n].to(torch.int32)
