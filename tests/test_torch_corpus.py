"""The port's corpus scanning facade (``parallel/corpus.py``): the cases of
``tests/test_corpus.py`` on the port, each result also held against the JAX
package's ``scan_corpus`` on the same documents."""

import dataclasses

import numpy as np
import pytest

import ahocorasick_tpu as act
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.parallel import corpus as jax_corpus
from ahocorasick_tpu_torch.parallel.corpus import CorpusStats, scan_corpus


def _same_stats(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    g.pop("seconds"), w.pop("seconds")
    assert g == w


@pytest.mark.parametrize("engine", ["gold", "device"])
def test_scan_corpus_basic(engine):
    m = port.AhoCorasickSet(["he", "she"], engine=engine, device="cpu")
    docs = ["she said", "nothing", "hehe", "naïve \U0001F600 she"]
    results, stats = scan_corpus(m, docs)
    assert results == [m.match(d) for d in docs]
    assert stats.documents == 4
    assert stats.matches == 2 + 0 + 2 + 2
    assert stats.retries == 0 and stats.gold_fallbacks == 0
    assert stats.units == 8 + 7 + 4 + 12  # the astral code point counts 2
    assert stats.seconds > 0 and stats.gbps > 0
    jres, jstats = jax_corpus.scan_corpus(act.AhoCorasickSet(["he", "she"], engine=engine), docs)
    assert results == jres
    _same_stats(stats, jstats)
    assert [f.name for f in dataclasses.fields(CorpusStats)] == [
        f.name for f in dataclasses.fields(jax_corpus.CorpusStats)]


def test_scan_corpus_streams_results():
    m = port.AhoCorasickMap(["a"], ["A"], engine="gold", device="cpu")
    seen = []
    scan_corpus(m, ["a", "b"], on_result=lambda i, ms: seen.append((i, ms)))
    assert seen == [(0, [(0, 1, "A")]), (1, [])]


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_scan_corpus_retries_then_gold_fallback(is_map):
    def flaky_matcher(pkg, **kw):
        m = (pkg.AhoCorasickMap(["he"], ["H"], engine="gold", **kw) if is_map
             else pkg.AhoCorasickSet(["he"], engine="gold", **kw))
        calls = {"n": 0}
        orig = m.match

        def flaky(doc, listener=None):
            calls["n"] += 1
            if calls["n"] <= 3:
                raise RuntimeError("transient device failure")
            return orig(doc, listener)

        m.match = flaky
        return m

    results, stats = scan_corpus(flaky_matcher(port, device="cpu"), ["he there"], max_retries=2)
    # Three failures exhaust the attempts; only two were retries (the last
    # failure retries nowhere); the gold fallback answers.
    assert results == [[(0, 2, "H"), (4, 6, "H")] if is_map else [(0, 2), (4, 6)]]
    assert stats.retries == 2
    assert stats.gold_fallbacks == 1
    jres, jstats = jax_corpus.scan_corpus(flaky_matcher(act), ["he there"], max_retries=2)
    assert results == jres
    _same_stats(stats, jstats)


def test_scan_corpus_reraises_for_a_matcher_on_a_card():
    """A matcher on a CUDA device gets its retries and then its own failure,
    never an answer from the gold engine on the host."""
    import torch

    m = port.AhoCorasickSet(["he"], engine="gold", device="cpu")
    calls = []

    def broken(doc, listener=None):
        calls.append(doc)
        raise RuntimeError("kernel launch failed")

    m.match = broken
    m.device = torch.device("cuda", 0)  # only the type is read
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        scan_corpus(m, ["he there"], max_retries=2)
    assert calls == ["he there"] * 3


def test_scan_corpus_raises_when_even_gold_fails():
    m = port.AhoCorasickSet(["he"], engine="gold", device="cpu")
    m.match = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    m.compiled = None  # breaks the gold fallback too
    with pytest.raises(RuntimeError, match="boom"):
        scan_corpus(m, ["he"], max_retries=0)


def test_determinism_across_runs_and_engines():
    """Same input, identical matches across runs, engines and packages."""
    rng = np.random.default_rng(11)
    kws = ["ab", "ba", "aab", "b", "abab"]
    text = "".join(rng.choice(list("ab "), size=4000))
    gold_m = port.AhoCorasickSet(kws, engine="gold", device="cpu")
    dev_m = port.AhoCorasickSet(kws, engine="device", device="cpu")
    first = dev_m.match(text)
    for _ in range(3):
        assert dev_m.match(text) == first
    assert gold_m.match(text) == first == act.AhoCorasickSet(kws, engine="device").match(text)
    docs = [text[i: i + 500] for i in range(0, 4000, 500)]
    assert scan_corpus(dev_m, docs)[0] == scan_corpus(gold_m, docs)[0]
