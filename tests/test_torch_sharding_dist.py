"""The port's sharded scan functions under a ``torch.distributed`` process group
(gloo, one rank per process, CPU tensors) vs their device-list form on the
same inputs: counts, planes, whole-word-longest walks on both branches,
arrival states (the stitch's forms for any table, and its synchronized
forms with ``sync_depth``), the table-sharded scan (one rank per row shard,
the step loop with an ``all_reduce`` per step; the 2-axis
``dp_tp_groups`` layout against ``dp_tp_mesh``, and the ``(world, 1)``
layout, whose one-rank model axis scans with ``table_sharded_scan`` and
never the step loop), the data-parallel
``ShardedScanner`` of every kind and its stream, the launch glue's
per-process shards (under the process group and under its 2-axis layout),
and the halos themselves: under gloo they travel by one ``all_gather``, and
a spy counts the ``batch_isend_irecv`` calls, which must be none; the
point-to-point route of NCCL groups is run on the same ranks.  One
spawn per world size runs every case; each rank writes
what it got to a file and the parent compares.  Everything compared is an
integer, so every comparison is exact.

This module holds the spawned ranks' function, so it imports neither JAX nor
the JAX package (``tests/test_torch_no_jax.py`` checks it)."""

import datetime
import os
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed

CPU = torch.device("cpu")
MODES = ("count", "count_packed", "planes", "hotstate", "raw")
CASES = ("count_packed", "count_packedcount", "count_reps", "planes_packed", "planes_hotstate",
         "wwl_scan", "wwl_mixed", "wwl_walk", "arrival", "arrival_empty", "arrival_sync",
         "tp_count", "tp_run_count_packed", "tp_run_planes", "tp_run_hotstate", "tp_run_raw",
         "tp_ac", "tp_ac_stream", "tp_hotstate", "tp_longest", "tp_shortest", "tp_wwl_mixed",
         *(f"tp_deep_{mode}" for mode in MODES),
         "tp2_count", "tp2_run_planes", "tp2_ac", "tp2_longest", "tp2_wwl_mixed",
         "tp1_count", "tp1_run_planes", "tp1_run_raw",
         "dp_ac", "dp_ac_stream", "dp_ac_layout", "dp_longest", "dp_shortest", "dp_whole_word",
         "dp_wwl", "launch_count", "launch_layout_count", "halos", "p2p_calls", "p2p_halos")
_INIT_TIMEOUT = datetime.timedelta(seconds=60)
_JOIN_TIMEOUT = 150.0


def _text(seed, n, alphabet):
    rng = random.Random(seed)
    return "".join(rng.choice(alphabet) for _ in range(n))


def _run_cases(mesh=None, group=None):
    """Every case through one form of the functions: name -> numpy array.
    ``p2p_calls`` counts the calls of ``batch_isend_irecv`` (a spy): the
    gloo route fetches its halos by ``all_gather`` and never sends point to
    point, and the device-list form sends nothing.  ``p2p_halos`` runs the
    halos through the point-to-point route that NCCL groups take: the group
    reports its backend as NCCL, and gloo carries the sends of CPU
    tensors."""
    import torch.distributed as dist

    from ahocorasick_tpu_torch.parallel import sharding

    calls, real = [], dist.batch_isend_irecv

    def spy(ops):
        calls.append(len(ops))
        return real(ops)

    dist.batch_isend_irecv = spy
    try:
        out = _cases(mesh, group)
        out["p2p_calls"] = np.asarray([len(calls)])
        backend = dist.get_backend
        dist.get_backend = lambda g=None: dist.Backend.NCCL
        try:
            out["p2p_halos"] = _halo_rows(sharding._Shards(mesh, group, CPU),
                                          np.random.default_rng(27))
        finally:
            dist.get_backend = backend
    finally:
        dist.batch_isend_irecv = real
    assert (len(calls) > out["p2p_calls"][0]) == (group is not None)
    assert set(out) == set(CASES)
    return out


def _halo_rows(sh, rng):
    """Every rank's ``(left halo, right halo)`` from ``sh.halos``, gathered
    in rank order as int64 rows: uint8, uint16 and int32 shards, halos of
    0 to 513 classes on either side."""
    import torch

    from ahocorasick_tpu_torch.parallel import sharding

    rows = []
    per = 1024
    for num_classes, left, right in ((27, 12, 0), (300, 5, 7), (None, 0, 9), (27, 64, 513),
                                     (70000, 3, 3)):
        top = 70000 if num_classes is None else num_classes
        cls_p = rng.integers(0, top, size=per * sh.world).astype(np.int32)
        shards = sh.scatter(cls_p, num_classes)
        halos = sh.halos(shards, left, right)
        mine = {}
        for r in sh.ranks:
            lh, rh = halos[r]
            assert lh.dtype == rh.dtype == shards[r].dtype and lh.device == shards[r].device
            assert (lh.shape[0], rh.shape[0]) == (left, right)
            both = sharding._cat([lh, rh]) if left + right else lh
            wide = sharding._signed(both).to(torch.int64)
            mine[r] = wide & 0xFFFF if both.dtype == torch.uint16 else wide
        rows.append(sh.gather_host(mine))
    return np.concatenate(rows)


def _cases(mesh, group):
    import ahocorasick_tpu_torch as port
    from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl
    from ahocorasick_tpu_torch.parallel import launch, sharding

    kw = dict(engine="device", device="cpu")
    form = dict(mesh=mesh, group=group)
    out = {}

    small = port.AhoCorasickSet(["ab", "abc", "fed", "caf", "e"], **kw)
    deep = port.AhoCorasickSet(["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"], **kw)
    text = _text(21, 5000, "abcdef ")
    deep_text = _text(7, 9000, "ab")
    for name, m, t in (("packed", small, text), ("packedcount", deep, deep_text)):
        prepare, count, which = sharding.make_sharded_counter(m, **form)
        assert which == name, which
        x = prepare(m._classes(t))
        out[f"count_{name}"] = np.asarray([count(x), m.count(t)])
        if name == "packed":
            out["count_reps"] = np.asarray([count(x, reps=3)])
    for name, m, t in (("packed", small, text), ("hotstate", deep, deep_text)):
        fn, which, chunk = sharding.make_sharded_planes(m, **form)
        assert which == name, which
        out[f"planes_{name}"] = fn(m._classes(t)).view(torch.int32).numpy()

    pure = port.WholeWordLongestMatchSet(["a", "b", "ab", "aab", " ", "!!"], **kw)
    mixed = port.WholeWordLongestMatchSet(["new york", "new", "york", "a b", "ab"],
                                          case_sensitive=False, **kw)
    assert scan_wwl.scan_applicable(pure.compiled)
    assert scan_wwl.mixed_scan_applicable(mixed.compiled)
    pure_cls = pure._classes(_text(504, 3000, "ab !"))
    mixed_cls = mixed._classes(_text(590, 900, ["new", "york", " ", "a", "b ", "!x"]))

    def walks(name, m, cls):
        outs = sharding.sharded_wwl_walks(m, cls, **form)
        assert (outs[5] is None) == (name != "wwl_mixed")
        # One 2-D array per case: the five or six planes as int64 rows.
        out[name] = np.stack([np.asarray(o, dtype=np.int64) for o in outs if o is not None])

    walks("wwl_scan", pure, pure_cls)
    walks("wwl_mixed", mixed, mixed_cls)
    applicable = scan_wwl.scan_applicable, scan_wwl.mixed_scan_applicable
    scan_wwl.scan_applicable = scan_wwl.mixed_scan_applicable = lambda m: False
    try:  # neither scan table: the per-start walk branch
        walks("wwl_walk", pure, pure_cls)
    finally:
        scan_wwl.scan_applicable, scan_wwl.mixed_scan_applicable = applicable

    cls = small._classes(_text(0, 301, "abcx"))
    out["arrival"] = sharding.sharded_arrival_states(small.dev.dfa_next, cls, **form)
    out["arrival_empty"] = sharding.sharded_arrival_states(small.dev.dfa_next, cls[:0], **form)
    # The goto closure synchronizes at its depth: the synchronized stitch.
    out["arrival_sync"] = sharding.sharded_arrival_states(
        small.dev.dfa_next, cls, sync_depth=max(small.compiled.max_depth, 1), **form)
    assert np.array_equal(out["arrival_sync"], out["arrival"])

    # The table-sharded scan: under a group each rank holds one row shard.
    pd = scan_batched.build_packed(small.compiled)
    cls = small._classes(text)
    tp = dict(form, device="cpu") if group is not None else form
    out["tp_count"] = np.asarray([
        sharding.sharded_table_count(pd.table, cls, pd.halo, pd.state_bits, chunk=256, **tp),
        small.count(text)])
    for mode in ("count_packed", "planes", "hotstate", "raw"):
        got = sharding._table_sharded_run(pd.table, cls[:700], pd.halo, pd.state_bits,
                                          form["mesh"], 256, mode, group=group, device="cpu")
        out[f"tp_run_{mode}"] = (np.asarray([got]) if isinstance(got, int)
                                 else got.view(torch.int32).numpy())

    def triples(m, t):
        ts = sharding.TableShardedScanner(m, **form)
        trip = np.stack(ts.match_triples(t))
        assert ts.count(t) == trip.shape[1] > 0
        return ts, trip

    ts, out["tp_ac"] = triples(small, text)
    st, parts = ts.stream(), []
    for a, b in ((0, 1203), (1203, 2011), (2011, len(text))):
        parts.append(np.stack(st.feed(text[a:b], is_final=b == len(text))))
    out["tp_ac_stream"] = np.concatenate(parts, axis=1)
    assert np.array_equal(out["tp_ac_stream"][:2], out["tp_ac"][:2])
    ts, out["tp_hotstate"] = triples(deep, deep_text[:3000])
    assert ts.layout == "hotstate"
    _, out["tp_longest"] = triples(port.LongestMatchSet(["ab", "abc", "bc", "c"], **kw),
                                   _text(51, 2500, "abc"))
    ts, out["tp_shortest"] = triples(
        port.ShortestMatchMap(["she", "he", "hers", "abab"], [1, 2, 3, 4], **kw),
        "ushers abababab heshe xx " * 13)
    assert ts.layout == "shortest"
    ts, out["tp_wwl_mixed"] = triples(mixed, _text(58, 700, ["new", "york", " ", "a", "b ", "!x"])
                                      + " new york a b")
    assert ts._wwl.has_cross

    # The step loop on the deep dictionary's count-packed table: a halo of
    # 79 classes, one lane a window, every mode.
    flat, dsb, dhalo = scan_batched.build_count_packed(deep.compiled)
    dtab = flat.reshape(deep.compiled.num_states, deep.compiled.num_classes)
    for mode in MODES:
        got = sharding._table_sharded_run(dtab, deep._classes(deep_text[:2000]), dhalo, dsb,
                                          form["mesh"], 128, mode, group=group, device="cpu")
        out[f"tp_deep_{mode}"] = (np.asarray([got]) if isinstance(got, int)
                                  else got.view(torch.int32).numpy())

    # The 2-axis form at the default shape: (1, 2) at world 2, (2, 2) at 4.
    # Every rank makes the same new_group calls in the same order.
    layout = sharding.dp_tp_mesh(mesh) if group is None else sharding.dp_tp_groups(group=group)
    two = dict(mesh=layout) if group is None else dict(group=layout, device="cpu")
    out["tp2_count"] = np.asarray([
        sharding.sharded_table_count(pd.table, cls, pd.halo, pd.state_bits, chunk=256, **two),
        small.count(text)])
    got = sharding._table_sharded_run(pd.table, cls[:1024], pd.halo, pd.state_bits,
                                      two.get("mesh"), 256, "planes", group=two.get("group"),
                                      device="cpu")
    out["tp2_run_planes"] = got.view(torch.int32).numpy()

    def triples2(m, t):  # 2,500 units: five windows, padded to the data axis
        return np.stack(sharding.TableShardedScanner(m, two.get("mesh"), group=two.get("group"))
                        .match_triples(t))

    out["tp2_ac"] = triples2(small, text[:2500])
    out["tp2_longest"] = triples2(port.LongestMatchSet(["ab", "abc", "bc", "c"], **kw),
                                  _text(51, 2500, "abc"))
    out["tp2_wwl_mixed"] = triples2(mixed, _text(58, 2400, ["new", "york", " ", "a", "b "]))

    # A model axis of one rank, the (world, 1) layout: every rank holds the
    # whole table and scans its data slice with table_sharded_scan (its twin
    # on CPU ranks), never the step loop; a spy on both counts.
    from ahocorasick_tpu_torch.kernels import table_sharded

    n = len(mesh) if group is None else torch.distributed.get_world_size(group)
    one = (dict(mesh=sharding.dp_tp_mesh(mesh, (n, 1))) if group is None
           else dict(group=sharding.dp_tp_groups((n, 1), group=group), device="cpu"))
    calls, saved = [], (table_sharded.group_scan, table_sharded.table_sharded_scan_plain)

    def never(*args, **kwargs):
        raise AssertionError("group_scan at a one-rank model axis")

    def spy(table, *args):
        calls.append(table.n_model)
        return saved[1](table, *args)

    table_sharded.group_scan, table_sharded.table_sharded_scan_plain = never, spy
    try:
        out["tp1_count"] = np.asarray([
            sharding.sharded_table_count(pd.table, cls, pd.halo, pd.state_bits, chunk=256, **one),
            small.count(text)])
        for mode in ("planes", "raw"):
            got = sharding._table_sharded_run(pd.table, cls[:1024], pd.halo, pd.state_bits,
                                              one.get("mesh"), 256, mode,
                                              group=one.get("group"), device="cpu")
            out[f"tp1_run_{mode}"] = got.view(torch.int32).numpy()
    finally:
        table_sharded.group_scan, table_sharded.table_sharded_scan_plain = saved
    # one scan a call: a rank's slice, or each of the mesh's n model groups
    assert calls == [1] * (3 if group is not None else 3 * n), calls

    # The data-parallel facade: every kind and its stream.
    def scanner(m, form=form):
        return sharding.ShardedScanner(m, form["mesh"], group=form["group"])

    def dp(m, t):
        sc = scanner(m)
        trip = np.stack(sc.match_triples(t))
        assert sc.count(t) == trip.shape[1] > 0
        return trip

    out["dp_ac"] = dp(small, text[:3000])
    st, parts = scanner(small).stream(), []
    for a, b in ((0, 999), (999, 2100), (2100, 3000)):
        parts.append(np.stack(st.feed(text[a:b], is_final=b == 3000)))
    out["dp_ac_stream"] = np.concatenate(parts, axis=1)
    assert np.array_equal(out["dp_ac_stream"][:2], out["dp_ac"][:2])
    # A 2-axis layout is taken as its parent: every rank a data shard.
    out["dp_ac_layout"] = np.stack(scanner(small, dict(mesh=mesh, group=None) if group is None
                                           else dict(mesh=None, group=layout))
                                   .match_triples(text[:3000]))
    out["dp_longest"] = dp(port.LongestMatchSet(["ab", "abc", "bc", "c"], **kw),
                           _text(52, 2500, "abc"))
    out["dp_shortest"] = dp(port.ShortestMatchMap(["she", "he", "hers", "abab"], [1, 2, 3, 4],
                                                  **kw), "ushers abababab heshe xx " * 13)
    out["dp_whole_word"] = dp(port.WholeWordMatchSet(["ab", "a", "bab"], **kw),
                              _text(53, 2500, "ab !"))
    out["dp_wwl"] = dp(pure, _text(54, 2500, "ab !"))

    # The launch glue: every process hands in its own slice of the corpus.
    world = len(mesh) if group is None else torch.distributed.get_world_size(group)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    corpus = small._classes(text)[: 1024 * world - 100]
    _, count, _ = sharding.make_sharded_counter(small, **form)
    if group is None:
        shards, offset = launch.prepare_process_local(
            corpus, mesh, 1024 * world, num_classes=small.compiled.num_classes)
    else:
        shards, offset = launch.prepare_process_local(
            corpus[rank * 1024: (rank + 1) * 1024], None, 1024,
            num_classes=small.compiled.num_classes, group=group, device="cpu")
        assert list(shards) == [rank]
    assert offset == rank * 1024
    out["launch_count"] = np.asarray([count(shards)])
    # Under a 2-axis layout (its parent group) the same slices, the same count.
    if group is None:
        out["launch_layout_count"] = out["launch_count"]
    else:
        shards, offset = launch.prepare_process_local(
            corpus[rank * 1024: (rank + 1) * 1024], None, 1024,
            num_classes=small.compiled.num_classes, group=layout, device="cpu")
        assert offset == rank * 1024 and list(shards) == [rank]
        _, count, _ = sharding.make_sharded_counter(small, group=layout)
        out["launch_layout_count"] = np.asarray([count(shards)])

    # The halo exchange itself: the gloo route (all_gather) against the
    # device-list form's slices of the neighbours.
    out["halos"] = _halo_rows(sharding._Shards(mesh, group, CPU), np.random.default_rng(27))
    return out


def _rank_main(rank, world, init_file, out_dir):
    """One spawned rank: every case through ``group=``, saved to a file."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=_INIT_TIMEOUT)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_run_cases(group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks_and_mesh(request, tmp_path_factory):
    """(per-rank results of the group form, results of the device-list
    form) at one world size; a rank that hangs fails the spawn in
    ``_JOIN_TIMEOUT`` seconds."""
    import torch.multiprocessing as mp

    world = request.param
    out_dir = tmp_path_factory.mktemp(f"gloo{world}")
    ctx = mp.spawn(_rank_main, args=(world, str(out_dir / "init"), str(out_dir)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + _JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in time"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    ranks = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks, _run_cases(mesh=[CPU] * world)


@pytest.mark.parametrize("case", CASES)
def test_group_form_equals_device_list_form(ranks_and_mesh, case):
    ranks, want = ranks_and_mesh
    assert want[case].size > 0 or case == "arrival_empty"
    for got in ranks:  # every rank returns the full result
        assert got[case].dtype == want[case].dtype and got[case].shape == want[case].shape
        np.testing.assert_array_equal(got[case], want[case])
    if case.startswith("count_p") or case in ("tp_count", "tp2_count", "tp1_count"):
        assert want[case][0] == want[case][1] > 0  # the single-device count


def test_mesh_and_group_are_exclusive():
    from ahocorasick_tpu_torch.parallel import sharding

    with pytest.raises(ValueError, match="not both"):
        sharding._Shards([CPU], object(), CPU)
