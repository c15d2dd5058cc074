"""Moore minimization of the scan tables (``probe8_minimize``) on the CPU
against the JAX probe of ``tools/probes/probe8_minimize.py``.

What each test compares:

* ``moore_minimize``'s ids and history, the port's (on the port's compiled
  dictionary and the port's emit signatures) against the JAX probe's (on
  the JAX package's), on small english-like dictionaries of the longest and
  AC kinds, both signatures (emit count and emit mask), three seeds;
* hand-made DFAs with a known minimum: two copies of a 3-cycle (3 classes),
  a DFA whose states are all equivalent (1), a chain that merges nothing
  (every state its own class);
* ``build_config`` at a small keyword count (the JAX one's
  ``english_like_keywords`` patched to the same count): the same states,
  classes and ``min_states`` for configs 3 and 5;
* ``run_config``'s records against the JAX ``main``'s printed records:
  the same keys, and the same values where they are not times (the JAX
  file rounds ``ratio`` and the sizes to 3 and 1 decimals).

Every compared value is an integer or a rounded ratio: exact equality.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools", "probes"))
import probe8_minimize as jprobe8  # noqa: E402

import ahocorasick_tpu.bench.__main__ as jbench_main  # noqa: E402
from ahocorasick_tpu.core.compiler import compile_matcher as jcompile  # noqa: E402
from ahocorasick_tpu.ops.scan_batched import _state_emit_planes as jplanes  # noqa: E402
from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords  # noqa: E402
from ahocorasick_tpu_torch.core.compiler import compile_matcher  # noqa: E402
from ahocorasick_tpu_torch.probes import probe8_minimize as probe8  # noqa: E402


def _jax_signatures(m) -> dict:
    planes = jplanes(m)
    mask = planes[:, 0].astype(np.uint64)
    if planes.shape[1] > 1:
        mask |= planes[:, 1].astype(np.uint64) << np.uint64(32)
    return {"count": m.emit_count[: m.num_states], "mask": mask}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["longest", "ac"])
def test_moore_minimize_matches_jax(kind, seed):
    kws = english_like_keywords(np.random.default_rng(seed), 300, 2, 7)
    kws += ["a" * i for i in range(1, 9)]
    pm, jm = compile_matcher(kws, kind, True), jcompile(kws, kind, True)
    psig, jsig = probe8.signatures(pm), _jax_signatures(jm)
    for name in ("count", "mask"):
        np.testing.assert_array_equal(psig[name], jsig[name])
        ids, hist = probe8.moore_minimize(pm.dfa_next, psig[name])
        jids, jhist = jprobe8.moore_minimize(jm.dfa_next, jsig[name])
        np.testing.assert_array_equal(ids, jids)
        assert hist == jhist and hist[-1] < pm.num_states


def _partition(ids) -> set:
    groups = {}
    for s, i in enumerate(ids):
        groups.setdefault(int(i), set()).add(s)
    return {frozenset(g) for g in groups.values()}


@pytest.mark.parametrize("case", ["two_cycles", "all_equal", "chain"])
def test_known_minimum(case):
    if case == "two_cycles":  # states i and i + 3 equivalent
        nxt = np.array([[1, 0], [2, 1], [0, 2], [4, 3], [5, 4], [3, 5]])
        init = np.array([0, 1, 1, 0, 1, 1])
        want = {frozenset({0, 3}), frozenset({1, 4}), frozenset({2, 5})}
    elif case == "all_equal":
        nxt = np.array([[1, 2], [2, 0], [0, 1], [3, 3]])
        init = np.zeros(4, np.int64)
        want = {frozenset(range(4))}
    else:  # only the last state emits: distance to it tells states apart
        nxt = np.minimum(np.arange(6)[:, None] + np.array([[1, 1]]), 5)
        init = np.array([0, 0, 0, 0, 0, 1])
        want = {frozenset({s}) for s in range(6)}
    for mod in (probe8, jprobe8):
        ids, hist = mod.moore_minimize(nxt, init)
        assert _partition(ids) == want and hist[-1] == len(want)


@pytest.mark.parametrize("which", ["3", "5"])
def test_build_config_and_records_match_jax(which, monkeypatch, capsys):
    n = 400
    real = jbench_main.english_like_keywords
    monkeypatch.setattr(jbench_main, "english_like_keywords", lambda rng, _n: real(rng, n))
    jm, pm = jprobe8.build_config(which), probe8.build_config(which, n)
    assert (pm.num_states, pm.num_classes) == (jm.num_states, jm.num_classes)
    np.testing.assert_array_equal(pm.dfa_next, jm.dfa_next)
    monkeypatch.setattr(sys, "argv", ["probe8_minimize.py", "--config", which])
    jprobe8.main()
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = probe8.run_config(which, n)
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("config", "signature", "states", "classes", "min_states",
                                  "iters")} == {k: w[k] for k in ("config", "signature",
                                                                   "states", "classes",
                                                                   "min_states", "iters")}
        assert (round(g["ratio"], 3), round(g["table_mb"], 1), round(g["min_table_mb"], 1)) == (
            w["ratio"], w["table_mb"], w["min_table_mb"])
