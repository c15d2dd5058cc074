"""Sequential DFA scans: the Hopper kernels and their plain PyTorch twins.

``seq_states(table, row_id, cls, s0, sync_depth)`` returns the arrival
states ``int32[N]`` of ``s = table[s, c]`` from the entry state ``s0``, over a
dense ``int32[S, A]`` table (``row_id=None``) or a row-deduplicated one
(``s = rows[row_id[s], c]``: ``table`` is ``rows int32[R, A]``, ``row_id``
``int32[S]``), with ``int32[N]`` classes; the carry to the next feed is
``states[-1]``.  Two forms, the same states:

* ``sync_depth=d`` declares the table d-synchronizing (a goto closure, d =
  ``max(max_depth, 1)``) and runs the lane scan: lanes of
  ``sync_lane_len(N, d)`` positions, lane 0 from ``s0``, every other lane
  from the root warmed over the d classes before it.
* ``sync_depth=None`` runs the form for a table that does not synchronize
  (the shortest matcher's restart table): speculate and repair.  The N
  classes are cut into chunks of ``K = spec_chunk_len(N)`` (the last one
  shorter); chunk 0 is walked from ``s0`` and every other chunk from the
  root, one lane a chunk; then the chunks are repaired in order: a chunk
  whose true entry (the state before it) is not the root is walked again
  from it until the new states meet the recorded ones, after which the
  recorded ones are exact.  Where ``N <= K`` it is one walk.  Its launch
  record keeps the name ``seq_states_serial``: "serial" names the form for
  tables that do not synchronize, no longer a single thread.

``shortest_states(dfa_next, match_len, cls)`` returns the arrival states
``int32[N]`` of ``s = dfa_next[match_len[s] > 0 ? 0 : s, c]`` from the root,
over tables padded as the JAX package pads them (``dfa_next`` int32[S_pad,
A_pad], ``match_len`` int32[S_pad]) and classes ``uint8``, ``uint16`` or
``int32[N]``.  That is the RowTable step over ``rows = dfa_next`` with
``row_id = restart_row_id(match_len)``, so it runs the same
speculate-and-repair kernels; the matcher's table cache builds that map
once per table (``_DeviceTables.restart_row_id``) and passes it.

The kernels (``csrc/seq_scan.cu``) replace the JAX package's
``core/stream.py`` ``_seqscan_jit`` runner (both table forms),
``ops/scan_dfa.py`` ``dfa_states`` (the dense form) and ``ops/scan_dfa.py``
``shortest_states``, each one ``lax.scan``.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernels for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches["seq_states"]`` (the lane scan),
``launches["seq_states_serial"]`` and ``launches["shortest_states"]`` (the
speculate-and-repair kernels, two launches a call where there is more than
one chunk) count wrapper calls that launched; ``build.seq_units`` adds up
the units the first two scanned.  ``spec_states`` and ``spec_states_plain``
return the repair length of every chunk too.
"""

from __future__ import annotations

import math

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


def restart_row_id(match_len: torch.Tensor) -> torch.Tensor:
    """``int32[S]``: the restart table's row of each state, 0 (the root's)
    for a match state and the state's own otherwise."""
    own = torch.arange(match_len.shape[0], dtype=torch.int32, device=match_len.device)
    return torch.where(match_len > 0, torch.zeros_like(own), own)


def shortest_states(dfa_next: torch.Tensor, match_len: torch.Tensor, cls: torch.Tensor,
                    row_id=None) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the shortest matcher's restart loop;
    ``row_id`` is ``restart_row_id(match_len)``, built here when not given."""
    _check(dfa_next, match_len, cls)
    if row_id is None:
        row_id = restart_row_id(match_len)
    elif row_id.dtype != torch.int32 or row_id.shape != match_len.shape or (
            row_id.device != cls.device or not row_id.is_contiguous()):
        raise ValueError(f"row_id must be a contiguous int32[{match_len.shape[0]}] on "
                         f"{cls.device}, got {row_id.dtype}{tuple(row_id.shape)} on "
                         f"{row_id.device}")
    if cls.device.type == "cpu":
        return spec_states_plain(dfa_next, row_id, cls, 0)[0]
    return _spec_launch("shortest_states", dfa_next, row_id, cls, 0, None)


def shortest_states_plain(dfa_next, match_len, cls) -> torch.Tensor:
    """The plain twin: the speculate-and-repair decomposition over the
    restart rows (``spec_states_plain``)."""
    return spec_states_plain(dfa_next, restart_row_id(match_len), cls, 0)[0]


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


# Speculate and repair takes about a K + b C: pass 1's longest lane of K
# dependent lookups, then the repair warp's C = N / K chunks, one after
# another (a mean repair of about one class, its loads and the warp's
# bookkeeping); least at K = sqrt(N * b / a).  The wrapper takes the power of
# two at or above sqrt(N * SPEC_REPAIR), SPEC_REPAIR standing for b / a.  On
# 64 Ki, 1 Mi and 32 Mi units of the 10k restart table the fastest of K / 4
# .. 4 K around the rule's with SPEC_REPAIR = 1 were K = 512, 2,048 and
# 8,192 (0.182, 0.707 and 4.030 ms; the 10k dense table the same K), which
# SPEC_REPAIR = 2 picks; the mean repair was 0.66-1.17 classes a chunk, the
# largest 11.  NVIDIA H100 80GB HBM3, 700 W; python -m
# ahocorasick_tpu_torch.bench.scan_variants (spec_ab).  SPEC_CHUNK_LEN, where
# set, is K itself whatever N (the tests' and the A/B's edges).
SPEC_REPAIR = 2
SPEC_CHUNK_LEN = None


def spec_chunk_len(n: int) -> int:
    """Speculate and repair's chunk length K for ``n`` units (``n <= K``:
    one chunk, one walk)."""
    if SPEC_CHUNK_LEN is not None:
        return int(SPEC_CHUNK_LEN)
    target = max(n * SPEC_REPAIR, 1)
    root = math.isqrt(target)
    root += root * root < target
    return min(1 << (root - 1).bit_length(), 1 << 30)


def seq_states(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int = 0,
               sync_depth=None) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the scan from ``s0``; ``row_id`` None
    for a dense table, else the state -> row map of a row-deduplicated one;
    ``sync_depth`` None for speculate and repair, else the depth d >= 1 at
    which the table synchronizes (the lane scan)."""
    s0 = int(s0)
    _check_seq(table, row_id, cls, s0)
    if sync_depth is not None:
        sync_depth = int(sync_depth)
        if sync_depth < 1:
            raise ValueError(f"sync_depth must be >= 1, got {sync_depth}")
    if cls.device.type == "cpu":
        return seq_states_plain(table, row_id, cls, s0, sync_depth)
    if sync_depth is None:
        return _spec_launch("seq_states_serial", table, row_id, cls, s0, None)
    dev = cls.device
    n = cls.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rid = None if row_id is None else row_id.data_ptr()
    build.call("seq_states_sync", table.data_ptr(), rid, cls.data_ptr(), n, table.shape[1], s0,
               sync_depth, sync_lane_len(n, sync_depth), out.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches["seq_states"] += 1
    seq_units["seq_states"] += n
    return out


def _spec_launch(name: str, table, row_id, cls, s0: int, repair) -> torch.Tensor:
    """Speculate and repair on the card, counted as ``name``; ``repair``
    int32[C] receives the repair lengths, or is None."""
    dev = cls.device
    n = cls.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    build.call("seq_states_spec", table.data_ptr(),
               None if row_id is None else row_id.data_ptr(), cls.data_ptr(),
               _CLASS_BYTES[cls.dtype], n, table.shape[1], s0, spec_chunk_len(n), out.data_ptr(),
               None if repair is None else repair.data_ptr(), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    launches[name] += 1
    if name in seq_units:
        seq_units[name] += n
    return out


def spec_states(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int = 0):
    """``(states int32[N], repair int32[C])``: speculate and repair with the
    repair length of each of its C chunks (``spec_chunk_len(N)`` classes
    each; 0 for chunk 0 and for a chunk entered at the root; the chunk's
    length where the walk never met the recorded states).  Classes uint8,
    uint16 or int32.  The twin on the CPU; on the card the kernels, counted
    as ``seq_states_serial``."""
    s0 = int(s0)
    if cls.dtype not in _CLASS_BYTES:
        raise TypeError(f"classes must be uint8, uint16 or int32, got {cls.dtype}")
    if cls.device.type == "cpu":
        return spec_states_plain(table, row_id, cls, s0)
    n = cls.shape[0]
    repair = torch.zeros(-(-n // min(spec_chunk_len(n), max(n, 1))), dtype=torch.int32,
                         device=cls.device)
    return _spec_launch("seq_states_serial", table, row_id, cls, s0, repair), repair


def seq_states_plain(table, row_id, cls, s0: int = 0, sync_depth=None) -> torch.Tensor:
    """The plain twin: the kernels' decomposition, speculate and repair
    (``sync_depth`` None) or the lane scan."""
    if sync_depth is not None:
        return _sync_states_plain(table, row_id, cls, s0, sync_depth)
    return spec_states_plain(table, row_id, cls, s0)[0]


def walk_rows(flat, rid, A: int, s: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """The states ``int64[lanes, L]`` of every lane of ``s int64[lanes]``
    stepped together over its row of ``body int64[lanes, L]``, over the flat
    ``int64`` table ``flat`` of row stride ``A`` (``rid`` None: dense, else
    the ``int64`` state -> row map): one batched indexing step a position.
    The twins' loop (this module's and ``kernels/stitch.py``'s)."""
    out = torch.empty(body.shape, dtype=torch.int64, device=body.device)
    for t in range(body.shape[1]):
        s = flat[(s if rid is None else rid[s]) * A + body[:, t]]
        out[:, t] = s
    return out


def _flat(table, row_id, cls):
    c = cls.to(torch.int64) if cls.dtype == torch.int32 else _widen(cls)
    return (table.reshape(-1).to(torch.int64),
            None if row_id is None else row_id.to(torch.int64), c)


def spec_states_plain(table, row_id, cls, s0: int = 0, chunk_len=None):
    """The twin of ``spec_states``: ``spec_rows_plain`` with one row entered
    in ``s0``.  ``chunk_len`` None: ``spec_chunk_len(N)``."""
    n = cls.shape[0]
    dev = cls.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    K = spec_chunk_len(n) if chunk_len is None else int(chunk_len)
    flat, rid, c = _flat(table, row_id, cls)
    states, repair = spec_rows_plain(flat, rid, table.shape[1],
                                     torch.tensor([s0], dtype=torch.int64, device=dev),
                                     c.reshape(1, n), K)
    return states[0].to(torch.int32), repair[0]


def spec_rows_plain(flat, rid, A: int, entry: torch.Tensor, body: torch.Tensor, K: int):
    """Speculate and repair by rows, in the kernels' decomposition:
    ``(states int64[R, L], repair int32[R, P])`` of the rows of ``body
    int64[R, L]``, row ``r`` entered in ``entry[r]`` (``int64[R]``), over the
    flat ``int64`` table ``flat`` of row stride ``A`` (``rid`` None: dense,
    else the state -> row map).  Each row is cut into P = ceil(L / K')
    sub-chunks of K' = min(K, L) classes.  Pass 1 is one batched indexing
    step per position over all R·P sub-chunks (sub-chunk 0 of a row from
    its entry, the others from the root; a row's last one padded with class
    0 and trimmed); then the repair loop over each row's sub-chunks in
    order, which rewalks one whose true entry is not the root until it
    meets the recorded states.  ``repair`` holds the positions each
    rewrote."""
    R, L = body.shape
    dev = body.device
    K = min(int(K), L)
    P = -(-L // K) if L else 0
    if R == 0 or L == 0:
        return (torch.empty((R, L), dtype=torch.int64, device=dev),
                torch.zeros((R, P), dtype=torch.int32, device=dev))
    padded = torch.zeros((R, P * K), dtype=torch.int64, device=dev)
    padded[:, :L] = body
    s = torch.zeros((R, P), dtype=torch.int64, device=dev)
    s[:, 0] = entry
    states = walk_rows(flat, rid, A, s.reshape(-1), padded.reshape(R * P, K))
    states = states.reshape(R, P * K)[:, :L].tolist()
    classes = body.tolist()
    repair = [[0] * P for _ in range(R)]
    for r in range(R):
        row, cls_r = states[r], classes[r]
        for chunk in range(1, P):
            base = chunk * K
            s = row[base - 1]
            if s == 0:  # entered at the root, as pass 1 walked it
                continue
            for i in range(base, min(base + K, L)):
                s = int(flat[(s if rid is None else int(rid[s])) * A + cls_r[i]])
                if s == row[i]:
                    break
                row[i] = s
                repair[r][chunk] += 1
    return (torch.tensor(states, dtype=torch.int64, device=dev),
            torch.tensor(repair, dtype=torch.int32, device=dev))


def _sync_states_plain(table, row_id, cls, s0: int, depth: int) -> torch.Tensor:
    n = cls.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=cls.device)
    L = sync_lane_len(n, depth)
    lanes = -(-n // L)
    flat, rid, cls64 = _flat(table, row_id, cls)
    A = table.shape[1]
    c = torch.zeros(lanes * L, dtype=torch.int64, device=cls.device)
    c[:n] = cls64
    s = torch.zeros(lanes, dtype=torch.int64, device=cls.device)
    s[0] = s0
    starts = torch.arange(1, lanes, device=cls.device) * L
    for t in range(depth):  # lanes 1.. warm up over the d classes before them
        w = s[1:]
        s[1:] = flat[(w if rid is None else rid[w]) * A + c[starts - depth + t]]
    # the last lane's steps past n read class 0 and are cut
    return walk_rows(flat, rid, A, s, c.reshape(lanes, L)).reshape(-1)[:n].to(torch.int32)
