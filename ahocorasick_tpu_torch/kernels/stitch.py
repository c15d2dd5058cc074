"""Chunk stitching by state maps: the Hopper kernels and their plain PyTorch
twins.

Three steps over a dense ``int32[S, A]`` transition table and ``int32[C, K]``
chunked classes:

* ``state_maps(table, cls, sync_depth)`` returns ``sigma int32[C, S]``:
  ``sigma[c, s]`` is the state reached from ``s`` over chunk ``c``;
* ``entry_fold(sigma, s0)`` returns ``entry int32[C]``: ``entry[0] = s0``,
  ``entry[c] = sigma[c - 1][entry[c - 1]]``, the state in which the one
  sequential scan enters each chunk; on the card by speculate and repair in
  one block (``csrc/stitch.cu`` ``entry_fold``): L lanes of ``per`` chunks
  (``fold_shape``, at most ``FOLD_LANES``), lane p folding its chunks from
  the guess ``sigma[p per - 1][s0]``, right wherever that map is constant
  (every map of a d-synchronizing table over a chunk longer than d), then
  the lanes whose guess was wrong re-folded in lane order from the exit
  of the lane before, each up to the first chunk whose recorded entry it
  meets;
* ``rescan(table, cls, entry, sync_depth)`` returns ``states int32[C, K]``:
  chunk ``c`` walked from ``entry[c]``.

``sync_depth=None`` runs the forms for any table, the only correct ones
for a table that does not synchronize (the shortest matcher's restart
table).  ``rescan`` is speculate and repair by rows (``csrc/seq_scan.cu``
``rescan_serial``): each chunk cut into sub-chunks of
``scan_dfa.spec_chunk_len(K)`` classes, the first walked from the chunk's
entry state and every other from the root, one lane each, then each chunk's
sub-chunks repaired in order, the chunks in parallel, a sub-chunk whose true
entry is not the root rewalked until it meets the recorded states.
``state_maps`` meets a reference run (``csrc/stitch.cu``
``state_maps_all``): R, each chunk's run from the root, is that rescan with
every entry the root; then each lane (chunk, s) walks from s until its state
equals R at the same position, where it follows R, so ``sigma[c, s] = R[c,
K - 1]``; a lane that never meets R walks to the chunk's end.  The cost is
about that of the rescan plus the lanes' walks until they meet: within d + 1
classes on a goto closure, a few classes past the next keyword end on the
restart table, the whole chunk for a sink.  ``sync_depth=d`` (an int >= 1)
declares the table d-synchronizing from every state reachable from the root
(a goto closure, d = ``max(max_depth, 1)``; the entry state ``s0`` reachable
or a zero-filled padding row) and runs the synchronized forms:
``state_maps`` walks all S lanes over the first ``t = min(K, d + 1)``
classes, tests whether they agree, and then walks the one agreed state over
the last classes (at most d) or, where the lanes disagree, every lane over
the whole chunk, so sigma is exact for any table; ``rescan`` is
``csrc/seq_scan.cu``'s lane scan with one row a chunk (lanes of
``scan_dfa.sync_lane_len(C * K, d)`` positions inside a chunk, lane 0 from
the entry state, every other lane from the root warmed over the d classes
before it).  Both forms give the same outputs.  ``meet_maps`` and
``spec_rescan`` return the forms for any table with their side outputs: each
lane's meet position and each sub-chunk's repair length; ``spec_fold``
returns the fold with each lane's re-folded length.

Together they replace the JAX package's ``ops/stitch.py``
(``chunk_state_maps``, ``entry_states``, ``stitched_states``) and the same
three loops inside ``parallel/sharding.py`` ``sharded_arrival_states``, where
each shard is the ``C = 1`` case.  ``rescan(table, cls, entry_fold(
state_maps(table, cls), s0))`` equals the sequential scan of the flattened
classes from ``s0`` bit for bit.  Every table row takes part, padding rows
included, as in the JAX functions.

A wrapper runs the plain twin of its form for tensors on the CPU, and
launches the kernel of its form for tensors on a CUDA device: there is no
fallback from one to the other, nor from one form to the other.
``launches`` (``kernels/build.py``) counts wrapper calls that launched, one
record per form: ``state_maps`` / ``state_maps_all``, ``entry_fold``,
``rescan`` / ``rescan_serial`` (names kept from the first designs:
"serial" and "all" name the forms for tables that do not synchronize).
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build, scan_dfa
from ahocorasick_tpu_torch.kernels.build import launches


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dims:
        raise TypeError(f"{name} must be int32 with {dims} dims, got {t.dtype}{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _one_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_table(table: torch.Tensor) -> None:
    _check("table", table, 2)
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"empty table {tuple(table.shape)}")


def _depth(sync_depth):
    """``sync_depth`` checked: None, or an int >= 1."""
    if sync_depth is None:
        return None
    d = int(sync_depth)
    if d != sync_depth or d < 1:
        raise ValueError(f"sync_depth must be an int >= 1, got {sync_depth!r}")
    return d


def _walk(flat: torch.Tensor, A: int, v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``v int64[R, S]`` walked over the columns of ``cols int64[R, n]``."""
    for k in range(cols.shape[1]):
        v = flat[v * A + cols[:, k : k + 1]]
    return v


# ------------------------------------------------------------ state maps (B15)


def state_maps(table: torch.Tensor, cls: torch.Tensor, sync_depth=None) -> torch.Tensor:
    """``sigma int32[C, S]`` of the chunks ``cls int32[C, K]``; ``sync_depth``
    None for any table (the lanes meet a reference run), else the depth d >=
    1 at which the table synchronizes (the synchronized form)."""
    _check_table(table)
    _check("cls", cls, 2)
    sync_depth = _depth(sync_depth)
    dev = _one_device(table, cls)
    if dev.type == "cpu":
        return state_maps_plain(table, cls, sync_depth)
    if sync_depth is None:
        return _meet_launch(table, cls, None)
    C, K = cls.shape
    S, A = table.shape
    sigma = torch.empty((C, S), dtype=torch.int32, device=dev)
    if C == 0:
        return sigma
    agree = torch.empty(2 * C, dtype=torch.int32, device=dev)  # set by the entry point
    build.call("state_maps", table.data_ptr(), cls.data_ptr(), C, K, S, A, sync_depth,
               agree.data_ptr(), sigma.data_ptr(), dev.index, _stream(dev))
    launches["state_maps"] += 1
    return sigma


def meet_maps(table: torch.Tensor, cls: torch.Tensor):
    """``(sigma int32[C, S], meet int32[C, S])``: the maps for any table and
    each lane's meet position, the first position i at which the lane's
    state equals the chunk's run from the root (0 for the root's lane), K
    where it never does.  The twin on the CPU; on the card the kernels,
    counted as ``state_maps_all``."""
    _check_table(table)
    _check("cls", cls, 2)
    dev = _one_device(table, cls)
    if dev.type == "cpu":
        return meet_maps_plain(table, cls)
    meet = torch.empty((cls.shape[0], table.shape[0]), dtype=torch.int32, device=dev)
    return _meet_launch(table, cls, meet), meet


def _meet_launch(table, cls, meet) -> torch.Tensor:
    """The maps for any table on the card; ``meet`` receives the meet
    positions, or is None."""
    dev = cls.device
    C, K = cls.shape
    S, A = table.shape
    sigma = torch.empty((C, S), dtype=torch.int32, device=dev)
    if C == 0:
        return sigma
    run = torch.empty((C, K), dtype=torch.int32, device=dev)  # the reference runs
    build.call("state_maps_all", table.data_ptr(), cls.data_ptr(), C, K, S, A,
               scan_dfa.spec_chunk_len(K), run.data_ptr(), sigma.data_ptr(),
               None if meet is None else meet.data_ptr(), dev.index, _stream(dev))
    launches["state_maps_all"] += 1
    return sigma


def state_maps_plain(table: torch.Tensor, cls: torch.Tensor, sync_depth=None) -> torch.Tensor:
    """The plain twin.  For any table: ``meet_maps_plain``.  Synchronized:
    the kernels' decomposition, phase 1 over the first ``min(K, d + 1)``
    columns, the agreement test per chunk, then the agreed state over the
    last (at most d) columns, or every lane of a chunk that disagrees over
    all K."""
    if sync_depth is None:
        return meet_maps_plain(table, cls)[0]
    C, K = cls.shape
    S, A = table.shape
    flat = table.reshape(-1).to(torch.int64)
    lanes = torch.arange(S, dtype=torch.int64, device=cls.device).repeat(C, 1)
    c = cls.to(torch.int64)
    t = min(K, sync_depth + 1)
    v = _walk(flat, A, lanes, c[:, :t])
    lo, hi = v.min(dim=1).values, v.max(dim=1).values
    agreed = lo == hi
    sigma = torch.empty((C, S), dtype=torch.int64, device=cls.device)
    rows = agreed.nonzero().squeeze(1)
    if rows.numel():
        sigma[rows] = _walk(flat, A, lo[rows, None], c[rows, max(t, K - sync_depth):])
    rows = (~agreed).nonzero().squeeze(1)
    if rows.numel():
        sigma[rows] = _walk(flat, A, lanes[rows], c[rows])
    return sigma.to(torch.int32)


def meet_maps_plain(table: torch.Tensor, cls: torch.Tensor):
    """The twin of ``meet_maps``, in the kernels' decomposition: R, each
    chunk's run from the root, by ``scan_dfa.spec_rows_plain``; then every
    lane but the root's stepped column by column, one batched gather over
    the lanes still live, a lane leaving at its first equality with R."""
    C, K = cls.shape
    S, A = table.shape
    dev = cls.device
    v = torch.arange(S, dtype=torch.int64, device=dev).repeat(C, 1)
    meet = torch.full((C, S), K, dtype=torch.int64, device=dev)
    if C == 0 or K == 0:
        return v.to(torch.int32), meet.to(torch.int32)
    flat = table.reshape(-1).to(torch.int64)
    c = cls.to(torch.int64)
    run, _ = scan_dfa.spec_rows_plain(flat, None, A, torch.zeros(C, dtype=torch.int64,
                                                                 device=dev),
                                      c, scan_dfa.spec_chunk_len(K))
    meet[:, 0] = 0  # the root's lane is R
    live = v != 0
    for i in range(K):
        rows, cols = live.nonzero(as_tuple=True)
        if rows.numel() == 0:
            break
        step = flat[v[rows, cols] * A + c[rows, i]]
        v[rows, cols] = step
        hit = step == run[rows, i]
        meet[rows[hit], cols[hit]] = i
        live[rows[hit], cols[hit]] = False
    sigma = torch.where(meet < K, run[:, K - 1 :], v)
    return sigma.to(torch.int32), meet.to(torch.int32)


# ------------------------------------------------------------ entry fold (B15)

# The fold's lanes at most, one block of the card: the best of 32 to 1,024
# in bench/scan_variants.fold_ab at the demo dictionary's 4,096 chunks.
FOLD_LANES = 1024


def fold_shape(C: int) -> tuple:
    """``(per, L)``: the fold's chunks a lane and its lanes for C chunks."""
    if C == 0:
        return 0, 0
    per = -(-C // FOLD_LANES)
    return per, -(-C // per)


def _check_fold(sigma: torch.Tensor, s0) -> int:
    s0 = int(s0)
    _check("sigma", sigma, 2)
    if not 0 <= s0 < max(sigma.shape[1], 1):
        raise ValueError(f"entry state {s0} outside [0, {sigma.shape[1]})")
    return s0


def entry_fold(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """``entry int32[C]``: the state entering each chunk when chunk 0 is
    entered in ``s0``."""
    s0 = _check_fold(sigma, s0)
    dev = _one_device(sigma)
    if dev.type == "cpu":
        return entry_fold_plain(sigma, s0)
    return _fold_launch(sigma, s0, None)


def spec_fold(sigma: torch.Tensor, s0: int = 0):
    """``(entry int32[C], repair int32[L])``: the fold and each of the
    kernel's L lanes' re-folded length (``fold_shape``; 0 where the lane's
    guess was right).  The twin on the CPU; on the card the kernel, counted
    as ``entry_fold``."""
    s0 = _check_fold(sigma, s0)
    dev = _one_device(sigma)
    if dev.type == "cpu":
        return spec_fold_plain(sigma, s0)
    repair = torch.empty(fold_shape(sigma.shape[0])[1], dtype=torch.int32, device=dev)
    return _fold_launch(sigma, s0, repair), repair


def _fold_launch(sigma, s0, repair) -> torch.Tensor:
    dev = sigma.device
    C, S = sigma.shape
    entry = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return entry
    build.call("entry_fold", sigma.data_ptr(), C, S, s0, FOLD_LANES, entry.data_ptr(),
               None if repair is None else repair.data_ptr(), dev.index, _stream(dev))
    launches["entry_fold"] += 1
    return entry


def entry_fold_plain(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """The plain twin: a Python loop over the chunks."""
    s = int(s0)
    out = []
    for c in range(sigma.shape[0]):
        out.append(s)
        if c + 1 < sigma.shape[0]:
            s = int(sigma[c, s])
    return torch.tensor(out, dtype=torch.int32, device=sigma.device)


def spec_fold_plain(sigma: torch.Tensor, s0: int = 0):
    """The twin of ``spec_fold``, in the kernel's lanes: pass 1 folds every
    lane's chunks from its guess (lane 0 from ``s0``, lane p from
    ``sigma[p per - 1, s0]``) in one batched gather a step; pass 2 takes the
    lanes in order and re-folds each whose true entry, the exit of the lane
    before it, differs from its guess, up to the first chunk whose recorded
    entry equals the re-folded state."""
    C = sigma.shape[0]
    per, L = fold_shape(C)
    dev = sigma.device
    if C == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    sig = sigma.to(torch.int64)
    first = torch.arange(L, device=dev) * per
    s = torch.full((L,), int(s0), dtype=torch.int64, device=dev)
    s[1:] = sig[first[1:] - 1, int(s0)]
    guess = s.clone()
    entry = torch.empty(C, dtype=torch.int64, device=dev)
    for j in range(per):
        c = first + j
        on = c < C
        entry[c[on]] = s[on]
        step = c + 1 < C
        s[step] = sig[c[step], s[step]]
    exits, guess = s.tolist(), guess.tolist()
    rec = entry.tolist()
    repair = [0] * L
    for q in range(1, L):
        t = exits[q - 1]
        if t == guess[q]:
            continue
        c, to = q * per, min((q + 1) * per, C)
        while c < to and rec[c] != t:
            rec[c] = t
            if c + 1 < C:
                t = int(sig[c, t])
            c += 1
        repair[q] = c - q * per
        if c == to:
            exits[q] = t
    return (torch.tensor(rec, dtype=torch.int32, device=dev),
            torch.tensor(repair, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------- rescan (B15)


def rescan(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor,
           sync_depth=None) -> torch.Tensor:
    """``states int32[C, K]``: the arrival states of each chunk of ``cls``
    walked from its ``entry`` state; ``sync_depth`` None for any table
    (speculate and repair, one row a chunk), else the depth d >= 1 at which
    the table synchronizes (the lane scan, one row a chunk)."""
    _check_table(table)
    _check("cls", cls, 2)
    _check("entry", entry, 1)
    sync_depth = _depth(sync_depth)
    C, K = cls.shape
    if entry.shape[0] != C:
        raise ValueError(f"{entry.shape[0]} entry states for {C} chunks")
    dev = _one_device(table, cls, entry)
    if dev.type == "cpu":
        return rescan_plain(table, cls, entry, sync_depth)
    if sync_depth is None:
        return _spec_rescan_launch(table, cls, entry, None)
    out = torch.empty((C, K), dtype=torch.int32, device=dev)
    if C == 0 or K == 0:
        return out
    build.call("rescan", table.data_ptr(), cls.data_ptr(), entry.data_ptr(), C, K,
               table.shape[1], sync_depth, scan_dfa.sync_lane_len(C * K, sync_depth),
               out.data_ptr(), dev.index, _stream(dev))
    launches["rescan"] += 1
    return out


def spec_rescan(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor):
    """``(states int32[C, K], repair int32[C, P])``: the rescan for any table
    and the repair length of each of a chunk's P sub-chunks of
    ``scan_dfa.spec_chunk_len(K)`` classes (0 for the first and for one
    entered at the root; its length where the walk never met the recorded
    states).  The twin on the CPU; on the card the kernels, counted as
    ``rescan_serial``."""
    _check_table(table)
    _check("cls", cls, 2)
    _check("entry", entry, 1)
    C, K = cls.shape
    if entry.shape[0] != C:
        raise ValueError(f"{entry.shape[0]} entry states for {C} chunks")
    dev = _one_device(table, cls, entry)
    if dev.type == "cpu":
        return spec_rescan_plain(table, cls, entry)
    P = -(-K // min(scan_dfa.spec_chunk_len(K), K)) if K else 0
    repair = torch.zeros((C, P), dtype=torch.int32, device=dev)
    return _spec_rescan_launch(table, cls, entry, repair), repair


def _spec_rescan_launch(table, cls, entry, repair) -> torch.Tensor:
    """The rescan for any table on the card; ``repair`` receives the repair
    lengths, or is None."""
    dev = cls.device
    C, K = cls.shape
    out = torch.empty((C, K), dtype=torch.int32, device=dev)
    if C == 0 or K == 0:
        return out
    build.call("rescan_serial", table.data_ptr(), cls.data_ptr(), entry.data_ptr(), C, K,
               table.shape[1], scan_dfa.spec_chunk_len(K), out.data_ptr(),
               None if repair is None else repair.data_ptr(), dev.index, _stream(dev))
    launches["rescan_serial"] += 1
    return out


def rescan_plain(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor,
                 sync_depth=None) -> torch.Tensor:
    """The plain twin.  For any table: ``spec_rescan_plain``.  Synchronized:
    the kernel's decomposition, every lane of every chunk stepped together,
    one batched gather per warm-up class and per position of a lane."""
    if sync_depth is None:
        return spec_rescan_plain(table, cls, entry)[0]
    C, K = cls.shape
    if C == 0 or K == 0:
        return torch.empty((C, K), dtype=torch.int32, device=cls.device)
    A = table.shape[1]
    flat = table.reshape(-1).to(torch.int64)
    c = cls.to(torch.int64)
    L = scan_dfa.sync_lane_len(C * K, sync_depth)
    per = -(-K // L)
    body = torch.zeros((C, per * L), dtype=torch.int64, device=cls.device)
    body[:, :K] = c
    s = torch.zeros((C, per), dtype=torch.int64, device=cls.device)
    s[:, 0] = entry.to(torch.int64)
    starts = torch.arange(1, per, device=cls.device) * L
    for t in range(sync_depth):  # lanes 1.. of each chunk warm up inside it
        s[:, 1:] = flat[s[:, 1:] * A + body[:, starts - sync_depth + t]]
    # a chunk's last lane's steps past K read class 0 and are cut
    out = scan_dfa.walk_rows(flat, None, A, s.reshape(-1), body.reshape(C * per, L))
    return out.reshape(C, per * L)[:, :K].to(torch.int32)


def spec_rescan_plain(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor):
    """The twin of ``spec_rescan``: ``scan_dfa.spec_rows_plain`` with one row
    a chunk."""
    K = cls.shape[1]
    states, repair = scan_dfa.spec_rows_plain(
        table.reshape(-1).to(torch.int64), None, table.shape[1], entry.to(torch.int64),
        cls.to(torch.int64), scan_dfa.spec_chunk_len(K))
    return states.to(torch.int32), repair
