"""Million-keyword table-sharded scan in the port: the counterpart of
``tests/test_full_random_1m_tp.py``.

The 4.36M-state dictionary of the single-device 1M tests: its count-packed
table (470 MB) is row-sharded into eight separate allocations on the CPU, and
the hotstate extraction must give the pinned window count and the triples of
the port's single-device engine.  Marked ``slow``: the native compile and the
plain twin's column loop over 128 windows take about a minute."""

import numpy as np
import pytest

import ahocorasick_tpu_torch as port
from ahocorasick_tpu_torch.ops import scan_batched
from ahocorasick_tpu_torch.parallel import sharding
from test_full_random_1m import N_KEYWORDS, N_STATES, _keywords
from test_full_random_1m_tp import WINDOW_MATCHES


@pytest.mark.slow
def test_full_random_1m_table_sharded():
    kws, rng, letters = _keywords()
    assert len(kws) == N_KEYWORDS
    m = port.AhoCorasickSet(kws, engine="device", device="cpu")
    assert m.compiled.num_states == N_STATES
    assert scan_batched.hotstate_layout(m.compiled)

    n_units = 1 << 20
    text = list(letters[rng.integers(0, 26, size=n_units)].tobytes().decode())
    pos = rng.integers(0, n_units - 16, size=2000)
    kw_pick = rng.integers(0, len(kws), size=2000)
    for p, k in zip(pos, kw_pick):
        w = kws[k]
        text[p: p + len(w)] = w
    text = "".join(text)[:n_units]
    window = text[300_000: 300_000 + (1 << 16)]

    ts = sharding.TableShardedScanner(m, ["cpu"] * 8)
    assert ts.layout == "hotstate"
    s, e, v = ts.match_triples(window)
    assert len(s) == WINDOW_MATCHES == 80_030
    s1, e1, v1 = m.match_triples(window)
    np.testing.assert_array_equal(s, s1)
    np.testing.assert_array_equal(e, e1)
    np.testing.assert_array_equal(v, v1)
    assert ts.count(window) == WINDOW_MATCHES
    tables = ts._built["hotstate"][0]
    assert len(tables) == 1 and tables[0].n_model == 8
    assert tables[0].rows_per == -(-N_STATES // 8)
    assert ts._built["count_packed"][0] is tables
