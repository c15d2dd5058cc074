"""Entry points of the port: a single-device kernel check and a sharded dry
run — the counterparts of the JAX package's root ``__graft_entry__.py``.

``entry()`` returns the flagship forward step, the packed-scan planes kernel
(it replaces the reference's sequential match loop
``AhoCorasickSet.java:204-226``), as a function plus example arguments on the
device.

``dryrun_multigpu(n)`` builds an ``n``-shard mesh and runs the full sharded
scan step on tiny shapes: the data-parallel path (corpus shards, halo
exchange, count reduction, the sigma stitcher that provides the
sequence-parallel path, the shard-local resolves of the other four kinds, the
separator-spanning whole-word-longest dictionary and the sharded stream) and
the table-sharded path (the table's rows over the same devices as a model
mesh: emit planes, a resolved kind, the whole-word-longest raw plane, the
hotstate layout, the 2-axis data x model mesh when ``n`` is even and at least
4, and the separator-spanning dictionary).
"""

from __future__ import annotations

import numpy as np
import torch

_KEYWORDS = [
    "he", "she", "his", "hers", "the", "then", "them", "there",
    "and", "hand", "sand", "stand", "standard", "art", "start",
    "ten", "tent", "intent", "content", "entropy",
]


def _check(ok, what) -> None:
    """Raise unless ``ok`` (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(what)


def _demo_matcher(device=None):
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet

    return AhoCorasickSet(_KEYWORDS, engine="device", device=device)


def entry(device=None):
    """(fn, example_args): the packed-scan planes forward step.

    A seeded mid-size dictionary (1,500 words) that packs inline, so the
    dispatcher picks the packed-scan kernel family; ``fn`` is that kernel's
    emit-plane scan (its ``halo`` and ``state_bits`` are attributes of
    ``fn``) and ``example_args`` its table and the demo text's windows on
    ``device`` (CUDA by default)."""
    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import dispatch, scan_batched

    rng = np.random.default_rng(20260820)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = {  # real hits in the demo text below, amid seeded noise words
        "he", "she", "the", "there", "then", "and", "sand", "stand",
        "standard", "start", "art", "ten", "stood", "on",
    }
    while len(words) < 1500:
        n = int(rng.integers(3, 12))
        words.add("".join(rng.choice(letters, size=n)))
    m = AhoCorasickSet(sorted(words), engine="device", device=device)
    _check(dispatch.planes_plan(m.compiled, m.dev).which == "packed",
           "the demo dictionary must pack inline")

    pd = m.dev.packed_dfa
    text = "she stood there and then started standing on standard sand " * 64
    windows = scan_batched.chunk_classes(m._classes(text), 512, pd.halo, m.compiled.num_classes)
    halo, state_bits = pd.halo, pd.state_bits

    def fn(table, windows):
        return scan_block.packed_scan_planes(table, windows, halo, state_bits)

    fn.halo, fn.state_bits = halo, state_bits  # for a caller that checks the call
    example_args = (pd.table, scan_batched.classes_to_device(
        windows, m.compiled.num_classes, m.device))
    return fn, example_args


def dryrun_multigpu(n_shards: int, devices=None) -> None:
    """One sharded scan step over an ``n_shards`` mesh (tiny shapes).

    ``devices``: the mesh's ``n_shards`` devices; by default the visible
    CUDA devices, each taking a contiguous run of shards (one card takes
    them all)."""
    from ahocorasick_tpu_torch.core import gold
    from ahocorasick_tpu_torch.models.matchers import (
        AhoCorasickSet,
        LongestMatchSet,
        ShortestMatchSet,
        WholeWordLongestMatchSet,
        WholeWordMatchSet,
    )
    from ahocorasick_tpu_torch.ops import scan_dfa, stitch
    from ahocorasick_tpu_torch.ops import scan_batched
    from ahocorasick_tpu_torch.parallel.sharding import (
        ShardedScanner,
        TableShardedScanner,
        data_mesh,
        dp_tp_mesh,
        model_mesh,
    )

    if devices is None:
        visible = data_mesh()
        devices = [visible[r * len(visible) // n_shards] for r in range(n_shards)]
    mesh = data_mesh(devices)
    if len(mesh) != n_shards:
        raise RuntimeError(f"dryrun_multigpu({n_shards}) got a mesh of {len(mesh)} devices")
    first = mesh[0]

    m = _demo_matcher(first)
    text = "then she handed the standard tent there and started " * 40
    scanner = ShardedScanner(m, mesh)

    # Data-parallel path: sharded scan with halo exchange + sum reduction.
    total = scanner.count(text)
    starts, ends, vals = scanner.match_triples(text)
    _check(total == len(starts), (total, len(starts)))

    # Cross-check against the matcher's own single-device count.
    expected = m.count(text)
    _check(total == expected, (total, expected))

    # Sequence-parallel path: sigma-stitching of the dense DFA over
    # per-shard chunks of one stream.
    cls = m._classes(text)
    n = len(cls) - (len(cls) % n_shards)
    flat_cls = torch.from_numpy(cls[:n].astype(np.int32)).to(first)
    states = stitch.stitched_scan(m.dev.dfa_next, flat_cls.reshape(n_shards, -1))

    # And the exactness of the stitch vs one flat sequential scan.
    flat = scan_dfa.dfa_states(m.dev.dfa_next, flat_cls)
    np.testing.assert_array_equal(states.reshape(-1).cpu().numpy(), flat.cpu().numpy())

    # All five kinds through the sharded scanner: count + triples on the
    # mesh, gold-exact.  Longest / shortest exercise the shard-local resolve
    # with boundary stitching (resolve/parallel.py), whole-word the sharded
    # candidates + boundary filter, whole-word-longest the sharded walks +
    # restart chain (LongestMatchSet.java:211-232,
    # ShortestMatchSet.java:182-260, WholeWordMatchSet.java:47-132,
    # WholeWordLongestMatchSet.java:47-178 semantics).
    text5 = ("she handed the standard tent there then started standing "
             "intent on content and entropy hers art ") * 30
    for klass in (LongestMatchSet, ShortestMatchSet, WholeWordMatchSet,
                  WholeWordLongestMatchSet):
        mk = klass(_KEYWORDS, device=first)
        sck = ShardedScanner(mk, mesh)
        s5, e5, _ = sck.match_triples(text5)
        want = [(a, b) for a, b, _ in gold.GOLD_BY_KIND[mk.kind](mk.compiled, text5)]
        got = list(zip(s5.tolist(), e5.tolist()))
        _check(got == want, (mk.kind, got[:5], want[:5]))
        _check(sck.count(text5) == len(want), mk.kind)
        _check(len(want) > 0, mk.kind)  # the check must actually check spans

    # Table-sharded surface on the mesh: the table's rows sharded over a
    # model axis, full match surface gold-exact: packed-inline planes (AC), a
    # resolved kind, the whole-word-longest raw plane, then the hotstate
    # (state, count) layout of a dictionary whose emit mask overflows.
    tp_mesh = model_mesh(mesh)
    for mk in (m, LongestMatchSet(_KEYWORDS, device=first),
               WholeWordLongestMatchSet(_KEYWORDS, device=first)):
        ts = TableShardedScanner(mk, tp_mesh)
        s5, e5, _ = ts.match_triples(text5)
        want = [(a, b) for a, b, _ in gold.GOLD_BY_KIND[mk.kind](mk.compiled, text5)]
        _check(list(zip(s5.tolist(), e5.tolist())) == want, ("table-sharded", mk.kind))
        _check(ts.count(text5) == len(want) > 0, ("table-sharded count", mk.kind))

    mh = AhoCorasickSet(["a" * i for i in range(1, 40)] + ["the", "then"], engine="device",
                        device=first)
    _check(scan_batched.hotstate_layout(mh.compiled), "the deep dictionary packs inline")
    th = TableShardedScanner(mh, tp_mesh)
    _check(th.layout == "hotstate", th.layout)
    sh, eh, _ = th.match_triples(text5)
    wanth = [(a, b) for a, b, _ in gold.gold_ac(mh.compiled, text5)]
    _check(list(zip(sh.tolist(), eh.tolist())) == wanth, "table-sharded hotstate")

    # Data x model composition: windows sharded over the model groups, table
    # rows inside each group (2-axis mesh).
    if n_shards >= 4 and n_shards % 2 == 0:
        t2 = TableShardedScanner(m, dp_tp_mesh(mesh))
        s2, e2, _ = t2.match_triples(text5)
        want2 = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text5)]
        _check(list(zip(s2.tolist(), e2.tolist())) == want2, "data x model mesh")
        _check(t2.count(text5) == len(want2) > 0, "data x model count")

    # Separator-spanning whole-word-longest: the truncated-closure scan +
    # host continuations, data-parallel and table-sharded, vs gold.
    mx = WholeWordLongestMatchSet(
        ["new york", "new", "york", "the", "then"], case_sensitive=False, device=first)
    textm = ("then new york falls the new yorker rises new  york ") * 20
    wantm = [(a, b) for a, b, _ in gold.gold_whole_word_longest(mx.compiled, textm)]
    _check(len(wantm) > 0, "mixed wwl gold is empty")
    sm, em, _ = ShardedScanner(mx, mesh).match_triples(textm)
    _check(list(zip(sm.tolist(), em.tolist())) == wantm, "sharded mixed wwl")
    sm, em, _ = TableShardedScanner(mx, tp_mesh).match_triples(textm)
    _check(list(zip(sm.tolist(), em.tolist())) == wantm, "table-sharded mixed wwl")

    # Stream cursor on the mesh: three uneven chunks through the sharded
    # tail-carry stream must equal the one-shot gold match list (stream
    # carry at mesh scale, AhoCorasickMap.java:208-275).
    stream = scanner.stream()
    cuts = [0, len(text5) // 5, len(text5) // 2, len(text5)]
    got_s = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        ss, ee, _ = stream.feed(text5[a:b], is_final=(b == len(text5)))
        got_s += list(zip(ss.tolist(), ee.tolist()))
    want_s = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text5)]
    _check(got_s == want_s, "sharded stream")
