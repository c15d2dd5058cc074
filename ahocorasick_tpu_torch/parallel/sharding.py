"""Sharded scanning over several devices — the port of
``ahocorasick_tpu/parallel/sharding.py``: the data-parallel scanner (the text
is sharded, the tables replicated) and the table-sharded scanner (the table's
rows are sharded, the text replicated).

**Data-parallel.**  The corpus is sharded across the devices of a mesh; the
compiled tables are replicated (they are read-only and small next to the
text).  A scan lane reads at most ``max_depth`` classes beside its own shard,
so the only dependency between shards is a halo of the neighbour's classes;
the first shard's missing left halo and the last shard's missing right halo
are zeros, which is exactly ``PAD_CLASS``.  Counts reduce with a sum; planes
stay shard-local and are concatenated in text order, so global offsets are
just shard offsets (matches are chunk-local once the entry state is known,
``AhoCorasickMap.java:208-275``).

Where the JAX module runs ``shard_map`` bodies over a ``Mesh`` with
``ppermute`` / ``psum`` / ``all_gather``, the port runs one plain per-shard
function per rank over the existing kernels, in either of two forms:

* **a mesh**: an ordered list of ``torch.device``, in which a device may
  appear more than once (``[torch.device("cuda:0")] * 8`` runs eight shards
  on one card; the CPU tests pass ``[torch.device("cpu")] * 8``).  One
  process drives every shard; halos are slices of the neighbour's shard
  copied to this shard's device, the reduction is a sum of the per-shard
  counts and the gather a concatenation.  Tables are uploaded once per
  distinct device;
* **a process group** (``group=``, one rank per process under
  ``torch.distributed``: gloo on the CPU or several ranks on one card, NCCL
  over several GPUs): every rank calls the same function with the same host
  classes, takes its own shard on its own device, fetches its halos from its
  neighbours and reduces with ``all_reduce`` / ``all_gather``; every rank
  returns the full result.  The 2-axis group object of ``dp_tp_groups`` is
  taken as its parent group.
  Which collective carries the halos depends on the backend: under gloo one
  ``all_gather`` of a fixed-size record a rank (its tail and its head as
  bytes), since gloo carries point-to-point sends of CPU tensors only but
  ``all_gather`` of CPU and CUDA tensors alike; under NCCL
  ``batch_isend_irecv`` to the two neighbours.  Run: gloo on CPU ranks, gloo
  with CUDA tensors at worlds 2 and 4 on one card, NCCL at world 1 (where no
  halo travels); NCCL at world > 1 is unverified.

**Table-sharded** (``TableShardedScanner``, ``sharded_table_count``), for
dictionaries whose packed table exceeds one device's memory.  The packed table
is cut into contiguous row slices, one per device of the model axis, each a
separate allocation, and every window is scanned by the kernel of
``kernels/table_sharded.py``, which reads the shard that owns the current
state through an array of base pointers (the JAX body looks every shard up
under a mask and combines them with a ``psum`` per character).

* A **1-axis (model) mesh** is the list of devices above: shard k lies on
  ``mesh[k]``, the scan runs on ``mesh[0]``, and the text is not cut.
* A **2-axis (data, model) mesh** is a list of model groups, each a list of
  devices: ``mesh[i][k]`` is the device at position ``(i, k)`` of the JAX
  ``Mesh(devices.reshape(n_data, n_model), ("data", "model"))``.  Each model
  group holds the whole table in row shards and scans its contiguous slice of
  the windows; counts add and planes concatenate in text order
  (``dp_tp_mesh`` builds one).
* Shards on GPUs other than the scanning one are reached by peer access.
  Only meshes that name one card have been run (one H100): the several-GPU
  form is unverified.
* Under ``group=`` each rank holds one row shard on its own device and no
  rank reads another's rows: the scan is ``kernels/table_sharded.py``
  ``group_scan``, one ``table_sharded_step`` launch a step on the rank's
  shard and one ``all_reduce(SUM)`` of the lanes' words (int32) over the model
  ranks between launches, as the JAX body's gather under ``psum``; eager on
  gloo, a replayed CUDA graph on NCCL.  Where the model axis has one rank,
  that rank holds the whole table and scans with one ``table_sharded_scan``
  launch, with no all_reduce over the model axis.  A process
  group is a 1-axis layout, one rank per row shard; ``dp_tp_groups`` lays the
  ranks out in 2 axes as ``dp_tp_mesh`` does devices: each model subgroup
  scans its contiguous slice of the windows, counts are summed over the data
  subgroup and planes gathered over it in text order, so every rank returns
  the full result.  The collectives are ``all_reduce`` and ``all_gather``
  only, which gloo carries for CUDA tensors too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ahocorasick_tpu_torch.core import stream as core_stream
from ahocorasick_tpu_torch.kernels import stitch as stitch_kernels
from ahocorasick_tpu_torch.kernels import table_sharded
from ahocorasick_tpu_torch.models.matchers import _DeviceTables, _device_capable
from ahocorasick_tpu_torch.ops import dispatch, scan_batched, scan_wwl
from ahocorasick_tpu_torch.resolve.parallel import (
    resolve_longest_sharded,
    resolve_shortest_sharded,
)
from ahocorasick_tpu_torch.resolve.queue import resolve_longest, resolve_shortest
from ahocorasick_tpu_torch.resolve.wholeword import boundary_filter, follow_chain, word_starts


def data_mesh(devices=None) -> List[torch.device]:
    """The mesh: ``devices`` as ``torch.device``s in rank order, by default
    every visible CUDA device (raises without CUDA)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass the mesh's devices, e.g. "
                "[torch.device('cpu')] * 8")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [_indexed(torch.device(d)) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _tables_on(matcher, device: torch.device) -> _DeviceTables:
    """The matcher's device tables on ``device``: its own cache when that is
    its device, else one more cache per distinct device, kept on the
    matcher's."""
    device = _indexed(device)
    if device == _indexed(matcher.device):
        return matcher.dev
    key = ("shard_tables", str(device))
    if key not in matcher.dev._cache:
        matcher.dev._cache[key] = _DeviceTables(matcher.compiled, device)
    return matcher.dev._cache[key]


# --------------------------------------------------------------- the shards


def _signed(t: torch.Tensor) -> torch.Tensor:
    """uint16 classes as their int16 bits: slicing, concatenation and copies
    between devices and processes move the same bytes under either type."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _cat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([_signed(p) for p in parts]).view(parts[0].dtype)


def _left_halo(shards: Sequence[torch.Tensor], rank: int, halo: int) -> torch.Tensor:
    """Last ``halo`` classes of the left neighbour's shard on this shard's
    device (zeros before the start)."""
    mine = shards[rank]
    if rank == 0:
        return torch.zeros(halo, dtype=mine.dtype, device=mine.device)
    src = shards[rank - 1]
    return _signed(src)[src.shape[0] - halo :].to(mine.device).view(mine.dtype)


def _right_halo(shards: Sequence[torch.Tensor], rank: int, halo: int) -> torch.Tensor:
    """First ``halo`` classes of the right neighbour's shard on this shard's
    device (zeros past the end)."""
    mine = shards[rank]
    if rank == len(shards) - 1:
        return torch.zeros(halo, dtype=mine.dtype, device=mine.device)
    return _signed(shards[rank + 1])[:halo].to(mine.device).view(mine.dtype)


def _chunk_for(halo: int, chunk: int) -> int:
    """Window chunk length >= halo (multiples of the base chunk).

    The overlapped-window construction below requires halo <= chunk;
    split/hotstate-layout dictionaries can have halo (= max keyword
    length) beyond the 512 base, so the sharded scans widen the chunk
    instead of silently clamping the warmup."""
    return max(chunk, -(-halo // chunk) * chunk)


def _windows_on_device(cls_with_halo: torch.Tensor, chunk: int, halo: int) -> torch.Tensor:
    """(B, halo+chunk) overlapped windows from [halo | N_local] classes, on
    the classes' device."""
    if halo > chunk:  # callers widen via _chunk_for
        raise ValueError(f"halo {halo} exceeds the window chunk {chunk}")
    windows = _signed(cls_with_halo).unfold(0, halo + chunk, chunk).contiguous()
    return windows.view(cls_with_halo.dtype)


class _Shards:
    """The ranks this process drives and how they talk: every rank of a
    device-list mesh, or this process's one rank of a process group."""

    def __init__(self, mesh, group, device: torch.device):
        self.group = group = _process_group(group)
        if group is not None:
            if mesh is not None:
                raise ValueError("pass a mesh or a process group, not both")
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.ranks = [dist.get_rank(group)]
            self.devices = {self.ranks[0]: _indexed(torch.device(device))}
        else:
            mesh = data_mesh(mesh)
            self.world = len(mesh)
            self.ranks = list(range(self.world))
            self.devices = dict(enumerate(mesh))

    def scatter(self, cls_p: np.ndarray, num_classes: Optional[int]) -> dict:
        """rank -> that rank's slice of the padded host classes on its
        device, narrow (``class_dtype``) with ``num_classes``, else int32."""
        per = len(cls_p) // self.world
        out = {}
        for r in self.ranks:
            piece = cls_p[r * per : (r + 1) * per]
            if num_classes is None:
                out[r] = torch.from_numpy(np.ascontiguousarray(piece, dtype=np.int32)).to(
                    self.devices[r])
            else:
                out[r] = scan_batched.classes_to_device(piece, num_classes, self.devices[r])
        return out

    def halos(self, shards: dict, left: int, right: int) -> dict:
        """rank -> ``(left halo, right halo)`` of ``left`` / ``right``
        classes on the rank's device.  Under a gloo group the halos travel
        by one ``all_gather`` (``_gloo_halos``), under any other backend by
        point-to-point sends (``_p2p_halos``)."""
        if self.group is None:
            ordered = [shards[r] for r in range(self.world)]
            return {r: (_left_halo(ordered, r, left), _right_halo(ordered, r, right))
                    for r in self.ranks}
        import torch.distributed as dist

        rank = self.ranks[0]
        mine = shards[rank]
        lh = torch.zeros(left, dtype=mine.dtype, device=mine.device)
        rh = torch.zeros(right, dtype=mine.dtype, device=mine.device)
        # Bytes travel: gloo carries neither uint16 nor uint32 tensors.
        tail = mine[mine.shape[0] - left :].contiguous().view(torch.uint8)
        head = mine[:right].contiguous().view(torch.uint8)
        gloo = dist.get_backend(self.group) == dist.Backend.GLOO
        exchange = self._gloo_halos if gloo else self._p2p_halos
        exchange(tail, head, lh.view(torch.uint8), rh.view(torch.uint8))
        return {rank: (lh, rh)}

    def _p2p_halos(self, tail, head, lh, rh) -> None:
        """``halos`` under NCCL: ``tail`` to rank r + 1 and ``head`` to rank
        r - 1 by ``batch_isend_irecv``, rank r - 1's tail into ``lh`` and
        rank r + 1's head into ``rh``; the ends stay zeros (``PAD_CLASS``).
        The tests run it on gloo CPU ranks, which carry point-to-point sends
        of CPU tensors."""
        import torch.distributed as dist

        rank = self.ranks[0]
        left, right = len(tail), len(head)
        peer = lambda r: dist.get_global_rank(self.group, r)
        ops = []
        if rank + 1 < self.world and left:
            ops.append(dist.P2POp(dist.isend, tail, peer(rank + 1), self.group))
        if rank > 0 and right:
            ops.append(dist.P2POp(dist.isend, head, peer(rank - 1), self.group))
        if rank > 0 and left:
            ops.append(dist.P2POp(dist.irecv, lh, peer(rank - 1), self.group))
        if rank + 1 < self.world and right:
            ops.append(dist.P2POp(dist.irecv, rh, peer(rank + 1), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _gloo_halos(self, tail, head, lh, rh) -> None:
        """``halos`` under gloo, which carries point-to-point sends of CPU
        tensors only: every rank contributes one record of the same size,
        its ``tail`` then its ``head`` bytes, to one ``all_gather`` (CPU and
        CUDA tensors alike); rank r's left halo ``lh`` is filled from rank r
        - 1's tail, its right halo ``rh`` from rank r + 1's head, and the
        ends stay zeros (``PAD_CLASS``)."""
        import torch.distributed as dist

        if self.world == 1 or not (len(tail) or len(head)):
            return
        record = torch.cat([tail, head])
        every = [torch.empty_like(record) for _ in range(self.world)]
        dist.all_gather(every, record, group=self.group)
        rank = self.ranks[0]
        if rank > 0:
            lh.copy_(every[rank - 1][: len(tail)])
        if rank + 1 < self.world:
            rh.copy_(every[rank + 1][len(tail) :])

    def total(self, counts: dict) -> int:
        """Sum of the per-rank counts (0-d int64 tensors) over all ranks."""
        if self.group is None:
            return sum(int(c) for c in counts.values())
        import torch.distributed as dist

        t = counts[self.ranks[0]].reshape(1).to(torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return int(t[0])

    def gather(self, parts: dict) -> List[torch.Tensor]:
        """The per-rank tensors (equal shapes) of every rank, in rank order;
        the other ranks' arrive on this rank's device."""
        if self.group is None:
            return [parts[r] for r in range(self.world)]
        import torch.distributed as dist

        mine = parts[self.ranks[0]].contiguous()
        raw = mine.view(torch.uint8) if mine.dtype != torch.uint8 else mine
        bufs = [torch.empty_like(raw) for _ in range(self.world)]
        dist.all_gather(bufs, raw, group=self.group)
        return [b.view(mine.dtype) for b in bufs]

    def gather_host(self, parts: dict) -> np.ndarray:
        """``gather`` downloaded and concatenated."""
        return np.concatenate([t.cpu().numpy() for t in self.gather(parts)])


def _pad_to(cls: np.ndarray, total: int) -> np.ndarray:
    return np.pad(cls, (0, total - len(cls)), constant_values=scan_batched.PAD_CLASS)


# ------------------------------------------------- whole-word-longest walks


def sharded_wwl_walks(matcher, cls: np.ndarray, mesh=None, *, group=None):
    """Per-position whole-word-longest walk outcomes across the mesh.

    Every walk reads at most ``max_depth + 1`` classes past its own lane, so
    the only dependency between shards is a right halo (plus, on the scan
    branch, a left halo that warms the scan up); the last shard's halo
    arrives as zeros, exactly the non-word pad class the single-device path
    uses.  Outcomes are returned in global coordinates as ``(die, has, ms,
    me, mv, cont)`` host arrays; ``cont`` is None except on the
    truncated-closure (mixed-dictionary) scan, where True flags positions
    whose walk needs the full-trie host continuation
    (``scan_wwl.host_walks_at``).  The sequential restart chain is followed
    on the host (``resolve/wholeword.follow_chain``), mirroring the
    reference loop ``WholeWordLongestMatchSet.java:47-178``."""
    m = matcher.compiled
    sh = _Shards(mesh, group, matcher.device)
    d = scan_wwl.bucket_depth(m.max_depth)  # bucketed like single-device
    n = len(cls)

    pure = scan_wwl.scan_applicable(m)
    if pure or scan_wwl.mixed_scan_applicable(m):
        # Scan engine per shard: a LEFT halo of d classes makes the depth
        # plane exact at every local position (trie-prefix suffixes are <= d
        # long, the d-synchronization of the AC engines; the truncated
        # closure satisfies the same argument), and a RIGHT halo of
        # cw >= d + 1 covers walks dying past the shard edge.  Also the only
        # sharded path for row-compressed dictionaries.
        cw = _chunk_for(d + 1, 512)
        chunk = -(-max(n, 1) // (sh.world * cw)) * cw
        shards = sh.scatter(_pad_to(cls, chunk * sh.world), m.num_classes)
        halos = sh.halos(shards, d, cw)
        parts = {}
        for r in sh.ranks:
            tabs = _tables_on(matcher, sh.devices[r])
            sc = tabs.wwl_scan if pure else tabs.wwl_scan_mixed
            lh, rh = halos[r]
            windows = _windows_on_device(_cat([lh, shards[r], rh]), cw, d)
            outs = scan_wwl.wwl_scan_walks_all(
                sc.table, sc.rows_flat, sc.outrows, windows, halo=d, id_bits=sc.id_bits,
                depth_bits=sc.depth_bits, num_classes=sc.num_classes, d=d,
                row_layout=sc.row_layout, quotient=sc.quotient, n_keep=chunk, cross=not pure)
            parts[r] = _globalize(outs, r * chunk)
        outs = _gather_outcomes(sh, parts, n)
        return outs + (None,) if pure else outs

    chunk = max(-(-max(n, 1) // sh.world), d + 1)
    shards = sh.scatter(_pad_to(cls, chunk * sh.world), m.num_classes)
    halos = sh.halos(shards, 0, d + 1)
    parts = {}
    for r in sh.ranks:
        local = _cat([shards[r], halos[r][1]])
        tabs = _tables_on(matcher, sh.devices[r])
        outs = scan_wwl.wwl_walks(*tabs.wwl_walk, local, d, tabs.wwl_walk_derived)
        parts[r] = _globalize(outs, r * chunk)
    return _gather_outcomes(sh, parts, n) + (None,)


def _globalize(outs, off: int):
    """Shard-local ``(die, has, ms, me, mv[, cont])`` in text coordinates."""
    die, has, ms, me, mv = outs[:5]
    return (die + off, has, ms + off, me + off, mv) + tuple(outs[5:])


def _gather_outcomes(sh: _Shards, parts: dict, n: int):
    """The outcome planes of every shard as host arrays cut to ``n``."""
    k = len(next(iter(parts.values())))
    return tuple(sh.gather_host({r: p[i] for r, p in parts.items()})[:n] for i in range(k))


# ------------------------------------------------------------ arrival states


def sharded_arrival_states(table: torch.Tensor, cls: np.ndarray, mesh=None, *,
                           group=None, sync_depth=None) -> np.ndarray:
    """Exact sequential arrival states across the mesh via sigma-stitching.

    Each shard computes its sigma map (the state it leaves in, for every
    state it could be entered in), the (D, S) sigma set is gathered, the
    maps are folded into each shard's true entry state, and each shard
    rescans from it.  Exactly the stream-mode state-carry invariant
    (``AhoCorasickMap.java:208-275``) parallelized.  ``table`` is a dense
    total transition function ``int32[S(+pad), A]``.  ``sync_depth=None``
    runs the stitch kernels' forms for any table (``kernels/stitch.py``): a
    map is the shard's run from the root plus each lane's walk until it
    meets that run, the rescan speculate and repair a shard; ``sync_depth=d``
    declares the table d-synchronizing from the root (a goto closure, d =
    ``max(max_depth, 1)``) and runs their synchronized forms, S·(d + 1)
    lookups a map and a lane scan a shard.
    Returns int32[len(cls)] arrival states (s_1..s_N of the flat scan)."""
    sh = _Shards(mesh, group, table.device)
    n = len(cls)
    chunk = -(-max(n, 1) // sh.world)
    # Class 0 never advances toward a match but does change state in a total
    # DFA: pad with it and return only the first n states.
    shards = sh.scatter(_pad_to(cls, chunk * sh.world), None)
    tables = {}
    for r in sh.ranks:
        dev = sh.devices[r]
        if dev not in tables:
            tables[dev] = table if _indexed(table.device) == dev else table.to(dev)
    sigma = {r: stitch_kernels.state_maps(tables[sh.devices[r]], shards[r][None], sync_depth)
             for r in sh.ranks}
    gathered = sh.gather(sigma)
    sigmas = torch.cat([s.to(gathered[0].device) for s in gathered])  # (D, S)
    entry = stitch_kernels.entry_fold(sigmas, 0)
    states = {}
    for r in sh.ranks:
        dev = sh.devices[r]
        states[r] = stitch_kernels.rescan(tables[dev], shards[r][None],
                                          entry[r : r + 1].to(dev), sync_depth)[0]
    return sh.gather_host(states)[:n]


# ------------------------------------------------------- counts and planes


def _plans(matcher, sh: _Shards, make_plan):
    """``(plan_on, which, halo)``: ``make_plan`` (``dispatch.count_plan`` or
    ``planes_plan``) over the matcher's tables on each distinct device of
    ``sh``, built at first use; ``which`` and ``halo`` are the same on all."""
    plans = {}

    def plan_on(dev):
        if dev not in plans:
            plans[dev] = make_plan(matcher.compiled, _tables_on(matcher, dev))
        return plans[dev]

    first = plan_on(sh.devices[sh.ranks[0]])
    return plan_on, first.which, first.halo


def _shard_windows(sh: _Shards, shards: dict, chunk: int, halo: int) -> dict:
    """rank -> ``[left halo | shard]`` cut into windows on the rank's device."""
    halos = sh.halos(shards, halo, 0)
    return {r: _windows_on_device(_cat([halos[r][0], shards[r]]), chunk, halo)
            for r in sh.ranks}


def make_sharded_counter(matcher, mesh=None, chunk: int = 512, *, group=None):
    """Best-engine data-parallel match counter over the mesh.

    Runs on every shard the kernel ``ops/dispatch.count_plan`` picks for the
    single device, with the left halo taken from the neighbour.  Returns
    ``(prepare, count, which)``: ``prepare(cls)`` pads the class array and
    uploads each shard once, narrow; ``count(x, reps=1)`` is the all-shard
    sum of ``reps`` scans (for benchmarking: scan ``i`` rolls the windows by
    ``i``; ``reps=1`` for real use)."""
    m = matcher.compiled
    if m.is_row_compressed and not scan_batched.quotient_packable(m):
        raise ValueError(
            "row-compressed (wide-alphabet) matcher has no packed quotient "
            "device layout; use the host path")
    sh = _Shards(mesh, group, matcher.device)
    plan_on, which, halo = _plans(matcher, sh, dispatch.count_plan)
    chunk = _chunk_for(halo, chunk)

    def prepare(cls: np.ndarray) -> dict:
        per = -(-max(len(cls), 1) // (sh.world * chunk)) * chunk
        return sh.scatter(_pad_to(cls, per * sh.world), m.num_classes)

    def count(shards: dict, reps: int = 1) -> int:
        counts = {}
        for r, windows in _shard_windows(sh, shards, chunk, halo).items():
            plan = plan_on(sh.devices[r])
            tot = plan.fn(plan.tables, windows)
            for i in range(1, reps):
                rolled = torch.roll(_signed(windows), i, 0).view(windows.dtype)
                tot = tot + plan.fn(plan.tables, rolled)
            counts[r] = tot
        return sh.total(counts)

    return prepare, count, which


def make_sharded_planes(matcher, mesh=None, chunk: int = 512, *, group=None):
    """Plan-driven sharded emit-plane scan: ``(fn, which, chunk)`` where
    ``fn(cls) -> uint32[P, N_padded]``, a tensor on the first shard's device
    (so that ``ac_matches_batched`` compacts the hot positions there and
    downloads only them).

    Same structure as ``make_sharded_counter`` but for the planes plans, so
    huge dictionaries (split / hotstate layouts) shard-scan with their
    single-device kernels.  ``which`` tells the caller how to decode
    (``"hotstate"``: the packed (state, count) plane, else END-indexed emit
    planes); ``chunk`` is the window chunk the shard cuts are multiples of."""
    m = matcher.compiled
    sh = _Shards(mesh, group, matcher.device)
    plan_on, which, halo = _plans(matcher, sh, dispatch.planes_plan)
    chunk = _chunk_for(halo, chunk)

    def fn(cls: np.ndarray) -> torch.Tensor:
        per = -(-max(len(cls), 1) // (sh.world * chunk)) * chunk
        shards = sh.scatter(_pad_to(cls, per * sh.world), m.num_classes)
        bits = {}
        for r, windows in _shard_windows(sh, shards, chunk, halo).items():
            plan = plan_on(sh.devices[r])
            # Exactly per = B * chunk positions per shard: the all-shard
            # concatenation is contiguous in text order.
            bits[r] = plan.fn(plan.tables, windows)
        gathered = sh.gather(bits)
        home = gathered[0].device
        return torch.cat([b.view(torch.int32).to(home) for b in gathered], dim=1).view(
            torch.uint32)

    return fn, which, chunk


# ------------------------------------------------------- the table-sharded scan


def model_mesh(devices=None) -> List[torch.device]:
    """The 1-axis model mesh: shard k of the table lies on ``devices[k]``
    (default: every visible CUDA device)."""
    return data_mesh(devices)


def dp_tp_mesh(devices=None, shape: Optional[Tuple[int, int]] = None) -> List[List[torch.device]]:
    """2-axis data x model mesh: ``shape[0]`` model groups of ``shape[1]``
    devices each, cut from ``devices`` in order (the JAX
    ``devices.reshape(shape)``).  Text windows shard over the groups, table
    rows over the devices of a group, so the text is replicated only inside
    a model group.  Default shape: ``(2, n // 2)`` for an even ``n >= 4``,
    else ``(1, n)``."""
    devices = data_mesh(devices)
    n_data, n_model = _dp_tp_shape(len(devices), shape, "devices")
    return [devices[i * n_model : (i + 1) * n_model] for i in range(n_data)]


def _dp_tp_shape(n: int, shape: Optional[Tuple[int, int]], what: str) -> Tuple[int, int]:
    """``(n_data, n_model)`` for ``n`` devices or ranks: ``shape``, by default
    ``(2, n // 2)`` for an even ``n >= 4``, else ``(1, n)`` (the JAX
    ``dp_tp_mesh`` rule)."""
    if shape is None:
        shape = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    n_data, n_model = shape
    if n_data < 1 or n_model < 1 or n_data * n_model != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} {what}")
    return int(n_data), int(n_model)


class DpTpGroups:
    """A process group's ranks laid out in 2 axes, (data, model): the
    ``group=`` counterpart of ``dp_tp_mesh``, built by ``dp_tp_groups``.  Rank
    ``r`` of ``parent`` sits at ``position = (r // n_model, r % n_model)``, as
    device ``r`` in the JAX ``devices.reshape(shape)``; ``model`` is the
    subgroup of its row (the ranks whose row shards make one table), ``data``
    the subgroup of its column (the ranks that hold the same shard), None on
    a 1-axis layout."""

    def __init__(self, parent, shape: Tuple[int, int], model, data, position: Tuple[int, int]):
        self.parent = parent
        self.shape = shape
        self.model = model
        self.data = data
        self.position = position


def dp_tp_groups(shape: Optional[Tuple[int, int]] = None, group=None) -> DpTpGroups:
    """The 2-axis layout of ``group``'s ranks (default the world): one model
    subgroup per row of ``shape`` and one data subgroup per column, made with
    ``torch.distributed.new_group``.  Every rank of the world must call it,
    in the same order as its other ``new_group`` calls (ranks outside a
    subgroup make its call too).  Default shape: ``(2, n // 2)`` for an even
    ``n >= 4``, else ``(1, n)``."""
    import torch.distributed as dist

    parent = dist.group.WORLD if group is None else group
    n = dist.get_world_size(parent)
    n_data, n_model = _dp_tp_shape(n, shape, "ranks")
    rank = dist.get_rank(parent)
    if rank < 0:
        raise ValueError("this process is not a rank of the group")
    ranks = [dist.get_global_rank(parent, r) for r in range(n)]
    backend = dist.get_backend(parent)
    rows = [dist.new_group([ranks[i * n_model + k] for k in range(n_model)], backend=backend)
            for i in range(n_data)]
    cols = [dist.new_group([ranks[i * n_model + k] for i in range(n_data)], backend=backend)
            for k in range(n_model)]
    i, k = divmod(rank, n_model)
    return DpTpGroups(parent, (n_data, n_model), rows[i], cols[k], (i, k))


def _group_axes(group) -> DpTpGroups:
    """``group`` as a 2-axis layout: a process group is one model row."""
    if isinstance(group, DpTpGroups):
        return group
    import torch.distributed as dist

    n = dist.get_world_size(group)
    return DpTpGroups(group, (1, n), group, None, (0, dist.get_rank(group)))


def _process_group(group):
    """The process group the data-parallel functions shard over: a 2-axis
    layout's parent, every rank a data shard."""
    return group.parent if isinstance(group, DpTpGroups) else group


def _rank_device(device) -> torch.device:
    """This rank's device under ``group=``: ``device``, None meaning this
    process's current CUDA device (raises without CUDA, before any
    collective)."""
    from ahocorasick_tpu_torch.models.matchers import _resolve_device

    return _indexed(_resolve_device(device))


def _model_groups(mesh) -> List[List[torch.device]]:
    """The mesh as its model groups: one for a 1-axis mesh, ``n_data`` for a
    2-axis one."""
    if mesh is None:
        return [model_mesh()]
    mesh = list(mesh)
    if not (mesh and isinstance(mesh[0], (list, tuple))):
        return [data_mesh(mesh)]
    if any(isinstance(d, (list, tuple)) for g in mesh for d in g) or not all(
            isinstance(g, (list, tuple)) for g in mesh):
        raise ValueError("the table-sharded scan takes a 1-axis (model) or 2-axis "
                         "(data, model) mesh")
    groups = [data_mesh(g) for g in mesh]
    if len({len(g) for g in groups}) != 1:
        raise ValueError("the model groups of a 2-axis mesh must be equally long")
    return groups


def _shard_tensor(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Table rows as a ``torch.uint32`` tensor on ``device`` in an allocation
    of its own (also on the CPU, where ``.to`` alone would alias ``rows``)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    if not rows.flags.writeable:
        rows = rows.copy()
    return torch.from_numpy(rows.view(np.int32)).to(device, copy=True).view(torch.uint32)


def _table_sharded_run(packed_table: np.ndarray, cls: np.ndarray, halo: int, state_bits: int,
                       mesh, chunk: int, mode: str, *, group=None, device=None):
    """Table-sharded packed-DFA scan core: the table ``uint32[S, A]`` is
    sharded by rows over the mesh's model axis, the text replicated (and, on
    a 2-axis mesh, its windows sharded over the data axis).

    It trades one more indirection per character for memory capacity, and is
    for tables that do not fit one device; the data-parallel
    ``make_sharded_counter`` is the fast path whenever the table fits.

    Modes (payload = packed bits above ``state_bits``):
    ``count``        — payload is an emit mask; returns its total popcount.
    ``count_packed`` — payload is an emit count; returns its total sum.
    ``planes``       — returns the END-indexed emit-mask plane uint32[1, N]
                       (the contract of ``packed_scan_planes``).
    ``hotstate``     — returns the packed (state, count) word at positions
                       whose arrival state ends >= 1 keyword, 0 elsewhere
                       (the contract of ``packedcount_hotstate_plane``).
    ``raw``          — returns the packed word at every position.
    Counts are ints; planes are tensors on the first model group's scanning
    device (under ``group=``, on this rank's)."""
    tables, run, A = _table_sharded_build(packed_table, halo, state_bits, mesh, mode,
                                          group=group, device=device)
    return run(tables, scan_batched.chunk_classes(cls, chunk, halo, A))


def _table_sharded_build(packed_table: np.ndarray, halo: int, state_bits: int, mesh, mode: str,
                         *, group=None, device=None, tables=None):
    """``(tables, run, A)``: the uploaded row shards and the scan closure
    ``run(tables, windows)`` over host ``chunk_classes(cls, chunk, halo, A)``
    windows.

    Split from ``_table_sharded_run`` so that ``TableShardedScanner`` keeps
    both across calls: the scanner exists for tables at or above one device's
    memory, where an upload per call would dominate everything.  ``tables``
    hands in shards uploaded for another mode (the upload does not depend on
    the mode).

    Meshes: a 1-axis mesh shards the table's rows over its devices and scans
    every window on the first; a 2-axis mesh (a list of model groups)
    additionally shards the windows over the groups, each window carrying its
    own left halo, so data shards need no halo exchange; the number of
    windows must be a multiple of the number of groups.  ``tables`` is one
    ``kernels.table_sharded.ShardedTable`` per model group (a shard that two
    groups keep on one device is uploaded once).  Under ``group=`` (a process
    group, or a ``dp_tp_groups`` layout) ``tables`` is this rank's one shard
    on ``device`` (None: this process's current CUDA device), and ``run``
    scans the rank's slice of the windows, padded with all-PAD windows to a
    multiple of the data axis (the planes trimmed back): ``group_scan``, or
    ``table_sharded_scan`` where the model axis has one rank."""
    if mode not in table_sharded.MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {table_sharded.MODES}")
    packed_table = np.asarray(packed_table)
    if packed_table.dtype != np.uint32 or packed_table.ndim != 2:
        raise TypeError(f"expected a uint32[S, A] packed table, got "
                        f"{packed_table.dtype}{packed_table.shape}")
    S, A = packed_table.shape
    counting = mode in ("count", "count_packed")
    if group is not None:
        if mesh is not None:
            raise ValueError("pass a mesh or a process group, not both")
        return _table_sharded_group(packed_table, halo, state_bits, group,
                                    _rank_device(device), mode, tables)

    groups = _model_groups(mesh)
    n_model = len(groups[0])
    rows_per = -(-S // n_model)
    if tables is None:
        uploaded = {}

        def shard_on(k: int, dev: torch.device) -> torch.Tensor:
            if (k, dev) not in uploaded:
                uploaded[k, dev] = _shard_tensor(_shard_rows(packed_table, k, rows_per), dev)
            return uploaded[k, dev]

        tables = [table_sharded.ShardedTable([shard_on(k, d) for k, d in enumerate(g)])
                  for g in groups]

    def run(tables, windows):
        windows = np.asarray(windows)
        if windows.shape[0] % len(groups):
            raise ValueError(f"{windows.shape[0]} windows do not divide over "
                             f"{len(groups)} model groups: pad with all-PAD windows")
        per = windows.shape[0] // len(groups)
        parts = [table_sharded.table_sharded_scan(
            table, scan_batched.classes_to_device(windows[i * per : (i + 1) * per], A, g[0]),
            halo, state_bits, mode)
            for i, (g, table) in enumerate(zip(groups, tables))]
        if counting:
            return sum(int(p) for p in parts)
        if len(parts) == 1:
            return parts[0]
        home = parts[0].device
        return torch.cat([p.view(torch.int32).to(home) for p in parts], dim=1).view(torch.uint32)

    return tables, run, A


def _shard_rows(packed_table: np.ndarray, k: int, rows_per: int) -> np.ndarray:
    """Rows ``[k * rows_per, (k + 1) * rows_per)`` of the table, zero rows past
    its end (the last shards)."""
    rows = packed_table[k * rows_per : (k + 1) * rows_per]
    if len(rows) < rows_per:
        rows = np.pad(rows, ((0, rows_per - len(rows)), (0, 0)))
    return rows


def _table_sharded_group(packed_table: np.ndarray, halo: int, state_bits: int, group,
                         dev: torch.device, mode: str, tables):
    """The group form of ``_table_sharded_build``: rank ``(i, k)`` of the
    layout holds row shard k and scans data slice i of the windows.

    Where the model axis has one rank, that rank holds the whole table and
    the all_reduce over its model subgroup would be the identity: it scans
    its slice with one ``table_sharded_scan`` over its one shard, as the
    mesh form does.  Else it runs ``group_scan``'s step loop, an
    ``all_reduce`` over the model axis a step: as a replayed CUDA graph
    where that axis's backend is NCCL, eagerly elsewhere (gloo)."""
    import torch.distributed as dist

    axes = _group_axes(group)
    n_data, n_model = axes.shape
    i, k = axes.position
    S, A = packed_table.shape
    rows_per = -(-S // n_model)
    if tables is None:
        tables = [_shard_tensor(_shard_rows(packed_table, k, rows_per), dev)]
    graphs = (table_sharded.StepGraphs()
              if n_model > 1 and dist.get_backend(axes.model) == "nccl" else None)

    def reduce(words):
        # Exact in int32: at most one model rank's word is not 0.
        dist.all_reduce(words[0].view(torch.int32), op=dist.ReduceOp.SUM, group=axes.model)

    def scan(tables, mine):
        if n_model > 1:
            return table_sharded.group_scan([(k, tables[0])], mine, halo, state_bits, mode,
                                            reduce, graphs)[0]
        return table_sharded.table_sharded_scan(table_sharded.ShardedTable(tables), mine, halo,
                                                state_bits, mode)

    def run(tables, windows):
        windows = np.asarray(windows)
        B = windows.shape[0]
        per = -(-B // n_data)
        if per * n_data != B:  # all-PAD windows scan class 0 from the root: no emits
            windows = np.concatenate(
                [windows, np.zeros((per * n_data - B, windows.shape[1]), windows.dtype)])
        mine = scan_batched.classes_to_device(windows[i * per : (i + 1) * per], A, dev)
        out = scan(tables, mine)
        if mode in ("count", "count_packed"):
            if n_data > 1:
                out = out.reshape(1)
                dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axes.data)
            return int(out.sum())
        if n_data == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(n_data)]
        dist.all_gather([p.view(torch.int32) for p in parts], out.view(torch.int32),
                        group=axes.data)
        C = windows.shape[1] - halo
        return torch.cat([p.view(torch.int32) for p in parts], dim=1)[:, : B * C].view(
            torch.uint32)

    return tables, run, A


def sharded_table_count(packed_table: np.ndarray, cls: np.ndarray, halo: int, state_bits: int,
                        mesh=None, chunk: int = 512, *, group=None, device=None) -> int:
    """Table-sharded packed-DFA match count of ``next | emit << state_bits``
    (see ``_table_sharded_run``)."""
    return int(_table_sharded_run(packed_table, cls, halo, state_bits, mesh, chunk, "count",
                                  group=group, device=device))


class TableShardedScanner:
    """Table-sharded scanner with the full match surface for all five kinds.

    For dictionaries whose packed table exceeds one device's memory: the
    table's rows are sharded over the mesh, and ``match_triples`` delivers
    every (start, end, value) span exactly as the reference's ``match`` does
    at any size, for every variant (``AhoCorasickSet.java:193-252``,
    ``LongestMatchSet.java:211-232``, ``ShortestMatchSet.java:182-260``,
    ``WholeWordMatchSet.java:47-132``,
    ``WholeWordLongestMatchSet.java:47-178``).  The same
    candidates-then-resolve split as the data-parallel ``ShardedScanner``,
    with the candidate scan table-sharded:

    * ``ac`` — packed-inline emit planes (layout ``planes``), or the hotstate
      (state, count) plane for huge dictionaries, the masks recovered on the
      host (layout ``hotstate``);
    * ``longest`` — the AC candidate scan of its own packed table, then the
      exact greedy resolve;
    * ``shortest`` — a table-sharded scanner over the internal AC of the
      insert-surviving keywords, then the min-end resolve; artifacts loaded
      without that AC take the exact host cursor (layout ``host``);
    * ``whole_word`` — the AC candidate scan, then the boundary filter;
    * ``whole_word_longest`` — the packed scan table of ``ops/scan_wwl.py``
      in ``raw`` mode, then the every-position die sweep on the scanning
      device (``ops.scan_wwl.walks_from_raw``), which holds the table's
      outcome rows (32 B per state) but none of the table whole; the restart
      chain runs on the host (layout ``wwl``).

    ``mesh``: a 1-axis model mesh (a list of devices; default every visible
    CUDA device) or a 2-axis one (a list of model groups, ``dp_tp_mesh``);
    or ``group=``, a process group (one rank per row shard) or a
    ``dp_tp_groups`` layout, each rank scanning on the matcher's device."""

    def __init__(self, matcher, mesh=None, chunk: int = 512, *, group=None):
        self.matcher = matcher
        self.m = m = matcher.compiled
        self.group = group
        if group is not None:
            if mesh is not None:
                raise ValueError("pass a mesh or a process group, not both")
            _rank_device(matcher.device)  # raises without CUDA, before the group
            self.mesh = None
        else:
            self.mesh = _model_groups(mesh)
        self.chunk = chunk
        self._built = {}  # mode -> (tables, run, A)
        self._inner = None  # shortest: the scanner over the internal AC
        self._wwl = None  # whole_word_longest: the host WwlScan tables
        self._sweep = {}  # ... and (rows_flat, outrows) per scanning device
        if m.kind == "shortest":
            ac = getattr(matcher, "_ac", None)
            if ac is not None:
                self._inner = TableShardedScanner(ac, mesh, chunk, group=group)
                self.layout = "shortest"
            else:
                # An artifact loaded without its internal AC: the exact host
                # cursor, as in the data-parallel ShardedScanner.
                self.layout = "host"
            return
        if m.kind == "whole_word_longest":
            # The matcher's cached host tables: one closure build serves the
            # single-device, data-parallel and table-sharded paths, and the
            # table is uploaded here only as row shards.
            if scan_wwl.scan_applicable(m):
                sc = matcher.dev.wwl_scan_host
            elif scan_wwl.mixed_scan_applicable(m):
                # Separator-spanning dictionary: the truncated closure;
                # crossing walks are re-run by the sparse host walker.
                sc = matcher.dev.wwl_scan_mixed_host
            else:
                raise ValueError("whole-word-longest matcher has no packed scan table "
                                 "(unpackable shape); no table-sharded path applies")
            self._wwl = sc
            self._table = sc.table if sc.row_layout else sc.table.reshape(-1, sc.num_classes)
            self._sb = sc.id_bits
            self._halo = sc.halo
            self.layout = "wwl"
            return
        if scan_batched.inline_packable(m):
            pd = scan_batched.build_packed(m)
            self._table, self._sb, self._halo = pd.table, pd.state_bits, pd.halo
            self.layout = "planes"
        elif scan_batched.count_packable(m):
            flat, self._sb, self._halo = scan_batched.build_count_packed(m)
            self._table = flat.reshape(m.num_states, m.num_classes)
            self.layout = "hotstate"
        else:
            raise ValueError("matcher has neither a packed-inline nor a count-packed "
                             "layout; no table-sharded scan applies")

    def _scan(self, cls: np.ndarray, mode: str):
        if mode not in self._built:
            first = next(iter(self._built.values()), None)
            self._built[mode] = _table_sharded_build(
                self._table, self._halo, self._sb, self.mesh, mode, group=self.group,
                device=self.matcher.device, tables=None if first is None else first[0])
        tables, run, A = self._built[mode]
        windows = scan_batched.chunk_classes(cls, self.chunk, self._halo, A)
        n_data = 1 if self.mesh is None else len(self.mesh)  # a group's run pads its own
        if windows.shape[0] % n_data:
            # Windows shard over the data axis: pad their number up to a
            # multiple of its size with all-PAD windows (they scan class 0
            # from the root: no emits, and positions past the text are
            # trimmed anyway).
            pad = n_data - windows.shape[0] % n_data
            windows = np.concatenate(
                [windows, np.zeros((pad, windows.shape[1]), windows.dtype)])
        return run(tables, windows)

    def _sweep_tables(self, device: torch.device):
        """``(rows_flat or None, outrows)`` of the whole-word-longest tables
        on ``device``, uploaded at first use."""
        if device not in self._sweep:
            up = lambda a: None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device)
            self._sweep[device] = (up(self._wwl.rows_flat), up(self._wwl.outrows))
        return self._sweep[device]

    def count(self, text: str) -> int:
        if self.m.kind == "ac":
            mode = "count" if self.layout == "planes" else "count_packed"
            return int(self._scan(self.matcher._classes(text), mode))
        # Resolution and boundary filtering change the other kinds' counts.
        return int(len(self.match_triples(text)[0]))

    def stream(self) -> "ShardedStream":
        """Streaming cursor whose per-chunk scans run table-sharded on the
        mesh (AC kind, tail carry): streaming for dictionaries beyond one
        device's memory (``AhoCorasickMap.java:208-275`` at any size)."""
        return ShardedStream(self)

    def match_triples(self, text: str):
        """(starts, ends, value_ids) in reference emission order."""
        return self.match_triples_classes(self.matcher._classes(text))

    def match_triples_classes(self, cls: np.ndarray):
        """``match_triples`` over a precomputed class array (the streaming
        cursor's entry point: feeds arrive as [tail | chunk])."""
        m = self.m
        if self.layout == "host":
            cursor = core_stream.make_cursor(m, self.matcher.device, self.matcher.dev)
            return _triples_from_list(cursor.feed(cls, is_final=True))
        if self.layout == "shortest":
            # The inner scanner scans its own charmap's classes; positions
            # are shared (the same UTF-16 text).
            return resolve_shortest(*self._inner.match_triples_classes(
                self.matcher._ac_classes(cls)))
        if self.layout == "wwl":
            n = len(cls)
            if n == 0:
                return _triples_from_list([])
            sc = self._wwl
            d = sc.halo
            # The die sweep reads d + 1 positions past each start: pad so
            # that the raw plane covers them (PAD class 0 is a non-word dead
            # end).
            cls_p = np.pad(cls, (0, d + 1))
            raw = self._scan(cls_p, "raw")[0]
            outs = [x.cpu().numpy() for x in scan_wwl.walks_from_raw(
                sc, *self._sweep_tables(raw.device), raw, cls_p, n)]
            die, has, ms, me, mv = outs[:5]
            ws = word_starts(np.asarray(m.class_is_word)[cls])
            if sc.has_cross:
                lanes = scan_wwl.chain_lanes(ws, n)
                need = lanes[outs[5][lanes]]
                scan_wwl.apply_crossing_fixes(m, cls_p, d, (die, has, ms, me, mv), need, need)
            return _triples_from_list(follow_chain(die, has, ms, me, mv, ws, n))
        triples = scan_batched.ac_matches_batched(
            m, cls, self._scan(cls, self.layout), layout=self.layout)
        if m.kind == "longest":
            return resolve_longest(*triples)
        if m.kind == "whole_word":
            return boundary_filter(m.class_is_word, cls, *triples)
        return triples


# ---------------------------------------------------------------- the facade


def _triples_from_list(trip):
    if not trip:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    a = np.asarray(trip, dtype=np.int64)
    return a[:, 0], a[:, 1], a[:, 2]


class ShardedScanner:
    """Data-parallel façade over a compiled matcher of any of the five kinds.

    ``count`` is an all-shard reduction; ``match_triples`` extracts exact
    global triples from shard-local planes.  ``mesh`` is a list of devices
    (default: every visible CUDA device); or ``group=``, a process group (or
    a ``dp_tp_groups`` layout, taken as its parent), one shard a rank on the
    matcher's device."""

    def __init__(self, matcher, mesh=None, *, group=None):
        m = matcher.compiled
        if not _device_capable(m, m.kind):
            raise ValueError(
                "row-compressed (wide-alphabet) matcher has no sharded "
                "device path for this kind; scan on the host path "
                "(matcher.match)")
        self.matcher = matcher
        self.group = group
        if group is not None:
            if mesh is not None:
                raise ValueError("pass a mesh or a process group, not both")
            _rank_device(matcher.device)  # raises without CUDA, before the group
            self.mesh = None
        else:
            self.mesh = data_mesh(mesh)
        self._inner = None  # shortest: lazy scanner over the internal AC
        self._counter = None  # lazy plan-driven sharded count closures
        self._planes = None  # lazy plan-driven sharded planes closures

    def _shard_boundaries(self, n: int, chunk: int = 512):
        """Per-shard cut positions in text coordinates (the same split
        ``make_sharded_planes`` uses): the resolve stitch points."""
        if self.group is None:
            n_dev = len(self.mesh)
        else:
            import torch.distributed as dist

            n_dev = dist.get_world_size(_process_group(self.group))
        per = -(-max(n, 1) // (n_dev * chunk)) * chunk
        return [per * i for i in range(1, n_dev)]

    def count(self, text: str) -> int:
        m = self.matcher.compiled
        if m.kind == "ac":
            if self._counter is None:
                self._counter = make_sharded_counter(self.matcher, self.mesh, group=self.group)
            prepare, count, _ = self._counter
            return int(count(prepare(self.matcher._classes(text)), reps=1))
        # Counting needs the resolved / filtered match set for the other
        # kinds (non-overlap resolution and boundary filtering change it).
        return len(self.match_triples(text)[0])

    def stream(self) -> "ShardedStream":
        """Streaming cursor whose per-chunk scans run on the mesh (AC kind:
        the d-synchronizing tail carry, ``AhoCorasickMap.java:208-275``)."""
        return ShardedStream(self)

    def match_triples(self, text: str):
        return self.match_triples_classes(self.matcher._classes(text))

    def match_triples_classes(self, cls: np.ndarray):
        """``match_triples`` over a precomputed class array (the sharded
        streaming cursor's entry point: feeds arrive as [tail | chunk])."""
        m = self.matcher.compiled
        if m.kind == "shortest":
            # Candidates-then-resolve: shard-scan the internal AC automaton
            # over the insert-surviving keywords, then the exact min-end
            # greedy resolve.  Matchers without a keyword source
            # (from_compiled artifacts) use the exact host cursor.
            ac = getattr(self.matcher, "_ac", None)
            if ac is not None and _device_capable(ac.compiled, "ac"):
                if self._inner is None:
                    self._inner = ShardedScanner(ac, self.mesh, group=self.group)
                # The internal AC sees the same UTF-16 unit count (classes
                # differ, positions don't), so the shard cuts follow the
                # INNER scanner's planes chunk.
                inner_trip = self._inner.match_triples_classes(
                    self.matcher._ac_classes(cls))
                inner_chunk = self._inner._planes[2]
                return resolve_shortest_sharded(
                    *inner_trip,
                    boundaries=self._shard_boundaries(len(cls), inner_chunk),
                    max_depth=ac.compiled.max_depth)
            cursor = core_stream.make_cursor(m, self.matcher.device, self.matcher.dev)
            return _triples_from_list(cursor.feed(cls, is_final=True))
        if m.kind == "whole_word_longest":
            die, has, ms, me, mv, cont = sharded_wwl_walks(self.matcher, cls, self.mesh,
                                                           group=self.group)
            ws = word_starts(np.asarray(m.class_is_word)[cls])
            if cont is not None:
                # Mixed dictionary: re-run the walks whose die char crossed
                # into the truncated region, at the positions the restart
                # chain can consume, as sparse host walks.
                d = scan_wwl.bucket_depth(m.max_depth)
                lanes = scan_wwl.chain_lanes(ws, len(cls))
                need = lanes[cont[lanes]]
                scan_wwl.apply_crossing_fixes(
                    m, np.pad(cls, (0, d + 1)), d, (die, has, ms, me, mv), need, need)
            return _triples_from_list(follow_chain(die, has, ms, me, mv, ws, len(cls)))
        if self._planes is None:
            self._planes = make_sharded_planes(self.matcher, self.mesh, group=self.group)
        fn, which, planes_chunk = self._planes
        layout = "hotstate" if which == "hotstate" else "planes"
        triples = scan_batched.ac_matches_batched(m, cls, fn(cls), layout=layout)
        if m.kind == "longest":
            # Shard-parallel resolve: each shard's candidates resolve
            # locally and the boundary (anchor, tail) stitch repairs the
            # interactions exactly (resolve/parallel.py;
            # SetMatchQueue.java:45-95 semantics).
            return resolve_longest_sharded(
                *triples, boundaries=self._shard_boundaries(len(cls), planes_chunk),
                max_depth=m.max_depth)
        if m.kind == "whole_word":
            # Boundary filter over AC candidates, the same equivalence the
            # single-device path uses (WholeWordMatchSet.java:47-132).
            return boundary_filter(m.class_is_word, cls, *triples)
        return triples


class ShardedStream:
    """Streaming cursor whose per-chunk scans run on the mesh.

    The same d-synchronizing tail-carry invariant as the single-device
    cursor (``core/stream._DfaCursor``; reference stream carry
    ``AhoCorasickMap.java:208-275``): the last ``max_depth`` classes replay
    as the next feed's left context, and candidates ending inside the tail
    region (already delivered last feed) are dropped, so an unbounded stream
    scans chunk-at-a-time with exact global offsets at any chunking."""

    def __init__(self, scanner):
        m = scanner.matcher.compiled
        if m.kind != "ac":
            raise ValueError(
                "sharded streaming carries the AC tail invariant; use the "
                "matcher's own stream() for the resolved/filtered kinds")
        self.scanner = scanner
        self.halo = max(m.max_depth, 1)
        self.tail = np.zeros(0, dtype=np.int32)
        self.off = 0  # global index of the next unit

    def feed(self, text: str, is_final: bool = False):
        """New matches this feed as GLOBAL (starts, ends, value_ids)."""
        cls = self.scanner.matcher._classes(text)
        if len(cls) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        starts, ends, vals = self.scanner.match_triples_classes(buf)
        keep_after = self.off - off0
        if keep_after > 0:
            keep = ends > keep_after
            starts, ends, vals = starts[keep], ends[keep], vals[keep]
        self.off += len(cls)
        keep_tail = min(len(buf), self.halo)
        self.tail = np.asarray(buf[len(buf) - keep_tail:], dtype=np.int32)
        return starts + off0, ends + off0, vals

    def state_dict(self) -> dict:
        return {"tail": self.tail.tolist(), "off": int(self.off)}

    def load_state_dict(self, d: dict) -> None:
        self.tail = np.asarray(d["tail"], dtype=np.int32)
        self.off = int(d["off"])
