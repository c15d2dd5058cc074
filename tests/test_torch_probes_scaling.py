"""The scaling probes (``probe9_scaling``, ``probe10_tp``) on the CPU against
the JAX probes of ``tools/probes/`` and the JAX package.

What each test compares, at 300 keywords and 4 Ki units (both probes draw
the same dictionary and text from ``default_rng(0)`` at these sizes):

* the values that are not times: probe9's one scan's count (the count plan
  over windows uploaded once) and its data-parallel count (one-device
  mesh), and probe10's ``total`` (``ac_kernel_rate``) and its timed call's
  count (8 reps), against the JAX package's ``AhoCorasickSet.count`` on the
  same text (the JAX probes' own harnesses scale to 128 Mi units a timed
  call and run JAX's sharded programs, which the CPU cannot afford here);
* the printed records' keys against the keys of the JSON records that the
  JAX files print (read from their sources), record by record;
* probe9's implied efficiencies from its own times, at the assumed
  latencies of 1, 10, 100 and 1,000 us.
"""

import ast
import os

import numpy as np
import pytest

from ahocorasick_tpu.bench.__main__ import english_like_keywords, word_soup
from ahocorasick_tpu.models.matchers import AhoCorasickSet
from ahocorasick_tpu_torch.probes import probe9_scaling, probe10_tp

PROBES = os.path.join(os.path.dirname(__file__), "..", "tools", "probes")
KEYWORDS, UNITS = 300, 4096


def _jax_record_keys(name: str) -> list:
    """The key lists of the dict literals the JAX file passes to
    ``json.dumps``, in source order."""
    with open(os.path.join(PROBES, name)) as fh:
        tree = ast.parse(fh.read())
    return [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


@pytest.fixture(scope="module")
def jax_count():
    rng = np.random.default_rng(0)
    kws = english_like_keywords(rng, KEYWORDS)
    text = word_soup(rng, kws, UNITS)
    return AhoCorasickSet(kws, engine="device").count(text)


def test_probe9_counts_and_records(jax_count):
    out = probe9_scaling.main(["--platform", "cpu", "--keywords", str(KEYWORDS), "--units",
                               str(UNITS)])
    assert out["scan_count"] == out["sharded_count"] == jax_count > 0
    recs = out["records"]
    want = _jax_record_keys("probe9_scaling.py")
    assert [list(r) for r in recs] == want[:2] + want[2:] * len(probe9_scaling.ASSUMED_US)
    t_scan, t_wrap = recs[0]["t_scan_ms"], max(recs[1]["t_wrap_ms"], 0)
    for rec, us in zip(recs[2:], probe9_scaling.ASSUMED_US):
        assert rec["assumed_ici_us"] == us
        assert rec["implied_weak_scaling_eff"] == pytest.approx(
            t_scan / (t_scan + t_wrap + us * 1e-3), rel=1e-12)


def test_probe10_counts_and_records(jax_count):
    out = probe10_tp.main("cpu", KEYWORDS, UNITS, min_units=0)
    assert out["total"] == jax_count > 0
    assert out["warm"] == jax_count * probe10_tp.REPS
    assert [list(r) for r in out["records"]] == _jax_record_keys("probe10_tp.py")
    assert out["records"][1]["layout"] == "planes"
