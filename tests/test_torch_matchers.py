"""Port matchers (``device="cpu"``: the kernels' plain twins) vs the JAX
package's ``engine="device"`` matchers and vs the gold model."""

import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _fuzz(seed, alphabet="abc", n_kw=12, max_len=5, n_text=600, noise=" "):
    rng = np.random.default_rng(seed)
    kws = sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
                  for _ in range(n_kw)})
    text = "".join(rng.choice(list(alphabet + noise), size=n_text))
    return kws, text


def _gold_pairs(m, text):
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_set_equals_jax_device_and_gold(seed):
    kws, text = _fuzz(seed)
    p = port.AhoCorasickSet(kws, engine="device", device="cpu")
    j = jax_pkg.AhoCorasickSet(kws, engine="device")
    want = _gold_pairs(p, text)
    assert p.match(text) == j.match(text) == want
    assert p.count(text) == j.count(text) == len(want)
    assert p.last_stats.engine == "device"


def test_map_case_folding_equals_jax_and_gold():
    kws = ["He", "SHE", "his", "hErS", "ß", "İ"]
    vals = [1, "two", (3,), {"k": 4}, None, 6.5]
    text = "UsHeRs sHe said HIS hers ß SS İi " * 5
    p = port.AhoCorasickMap(kws, vals, case_sensitive=False, engine="device", device="cpu")
    j = jax_pkg.AhoCorasickMap(kws, vals, case_sensitive=False, engine="device")
    want = [(s, e, vals[v]) for s, e, v in gold.gold_match(p.compiled, text)]
    assert p.match(text) == j.match(text) == want
    assert len(want) > 10


def test_non_bmp_text_counts_utf16_units():
    kws = ["\U0001F600", "a\U0001F600", "\U0001F600b", "\U0001F601"]
    text = "xa\U0001F600b \U0001F600\U0001F600 ab\U0001F601" * 3
    p = port.AhoCorasickSet(kws, engine="device", device="cpu")
    j = jax_pkg.AhoCorasickSet(kws, engine="device")
    want = _gold_pairs(p, text)
    assert p.match(text) == j.match(text) == want
    assert max(e for _, e in want) > len(text) // 2  # offsets are UTF-16 units


def test_empty_text_builds_no_tables():
    p = port.AhoCorasickSet(["ab", "b"], engine="device", device="cpu")
    assert p.match("") == []
    assert p.count("") == 0
    assert p.device_table_bytes() == 0


def test_listener_false_stops_delivery():
    kws, text = _fuzz(7)
    p = port.AhoCorasickSet(kws, engine="device", device="cpu")
    seen = []
    assert p.match(text, lambda t, s, e: seen.append((s, e)) or False) is None
    assert seen == _gold_pairs(p, text)[:1]
    seen_all = []
    p.match(text, lambda t, s, e: seen_all.append((s, e)))
    assert seen_all == _gold_pairs(p, text)
    pm = port.AhoCorasickMap(["ab", "b"], ["x", "y"], engine="device", device="cpu")
    got = []
    pm.match("abab", lambda t, s, e, v: got.append(v) or len(got) < 2)
    assert got == ["x", "y"]


def test_forced_sparse_compaction_path(monkeypatch):
    kws, text = _fuzz(11, n_text=5000, noise="defghijklmnopqrstuvwxyz ")
    monkeypatch.setattr(port_sb, "_SPARSE_ON_CPU", True)
    monkeypatch.setattr(port_sb, "_SPARSE_MIN_UNITS", 1024)
    calls = []
    real = port_sb.planes_to_sparse

    def spy(bits, n):
        out = real(bits, n)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(port_sb, "planes_to_sparse", spy)
    p = port.AhoCorasickMap(kws, list(range(len(kws))), engine="device", device="cpu")
    want = [(s, e, v) for s, e, v in gold.gold_match(p.compiled, text)]
    assert p.match(text) == want
    assert calls == [True]  # compacted, not the dense download
    assert len(want) > 100


def test_planes_to_sparse_contract(monkeypatch):
    monkeypatch.setattr(port_sb, "_SPARSE_ON_CPU", True)
    monkeypatch.setattr(port_sb, "_SPARSE_MIN_UNITS", 16)
    n, N = 100, 128  # positions >= n are padded lanes
    bits = np.zeros((1, N), dtype=np.uint32)
    hot = [3, 17, 64, 99, 120]
    bits[0, hot] = [1, 0x80000000, 5, 2, 7]
    t = torch.from_numpy(bits.view(np.int32)).view(torch.uint32)
    idx, masks = port_sb.planes_to_sparse(t, n)
    assert idx.tolist() == [3, 17, 64, 99]  # ascending, idx < n kept
    assert masks.dtype == np.uint32 and masks[:, 0].tolist() == [1, 0x80000000, 5, 2]
    dense = np.ones((1, N), dtype=np.uint32)  # > n // 4 hot: dense download
    assert port_sb.planes_to_sparse(torch.from_numpy(dense.view(np.int32)).view(torch.uint32), n) is None
    assert port_sb.planes_to_sparse(bits, n) is None  # host arrays stay dense


def test_jax_saved_npz_loads_through_the_port(tmp_path):
    kws = ["he", "she", "his", "hers"]
    j = jax_pkg.AhoCorasickMap(kws, ["v1", "v2", "v3", "v4"])
    path = tmp_path / "m.npz"
    j.save(path)
    p = port.load_matcher(path, engine="device", device="cpu")
    assert isinstance(p, port.AhoCorasickMap)
    text = "ushers and she said hishers"
    assert p.match(text) == j.match(text)
    assert len(p.match(text)) > 5
    jw = jax_pkg.WholeWordLongestMatchSet(kws)
    jw.save(tmp_path / "wwl.npz")
    pw = port.load_matcher(tmp_path / "wwl.npz", engine="device", device="cpu")
    assert isinstance(pw, port.WholeWordLongestMatchSet)
    assert pw.match(text) == jw.match(text) == [(11, 14)]


@pytest.mark.parametrize("dense", [True, False])
def test_device_table_bytes_equals_jax_batched(dense):
    kws, text = _fuzz(5, alphabet="abcdefg", n_kw=40, max_len=6)
    kw = {} if dense else {"thresholder": _NeverDense()}
    j = jax_pkg.AhoCorasickSet(kws, engine="device", **kw)
    j.device_engine = "batched"
    p = port.AhoCorasickSet(kws, engine="device", device="cpu", **kw)
    assert p.compiled.is_row_compressed == (not dense)
    assert p.count(text) == j.count(text)
    assert p.match(text) == j.match(text)
    assert p.device_table_bytes() == j.device_table_bytes() > 0
    assert p.host_table_bytes() == j.host_table_bytes() == p.compiled.memory_bytes()


DEEP = ["a" * i for i in range(1, 40)] + ["the"]  # count-packed / hotstate layout


def test_packed_overflow_dictionary_raises_not_implemented():
    """``engine="device"`` on a dictionary that does not pack inline takes
    the huge-dictionary layouts, from the constructor and ``from_compiled``
    alike, and answers as gold does."""
    from ahocorasick_tpu.core.compiler import compile_matcher

    text = "aaaa the " * 40 + "a" * 45 + "b aab"
    m = port.AhoCorasickSet(DEEP, engine="device", device="cpu")
    gold_m = port.AhoCorasickSet(DEEP, engine="gold", device="cpu")
    assert gold_m.count("aaaa the ") == 11
    assert m.match(text) == gold_m.match(text)
    # 40 x 11 in the "aaaa the" runs, sum(46 - i for i in 1..39) in a * 45, 3 in "aab"
    assert m.count(text) == gold_m.count(text) == 440 + 1014 + 3
    assert m.last_stats.engine == "device"
    compiled = compile_matcher(DEEP, "longest", True)
    assert not port_sb.inline_packable(carry(compiled))
    lm = port.LongestMatchSet.from_compiled(carry(compiled), engine="device", device="cpu")
    assert lm.match(text) == port.LongestMatchSet(DEEP, engine="gold", device="cpu").match(text)
    assert lm.last_stats.engine == "device"
    deep_prefix_free = ["a" * i + "b" for i in range(40)]  # the inner AC is deep too
    sm = port.ShortestMatchSet(deep_prefix_free, engine="device", device="cpu")
    assert not port_sb.inline_packable(sm._ac.compiled)
    assert sm.match(text) == port.ShortestMatchSet(deep_prefix_free, engine="gold",
                                                   device="cpu").match(text)
    assert sm.last_stats.engine == "device"


@pytest.mark.parametrize("name, kws", [
    ("AhoCorasickSet", DEEP), ("LongestMatchSet", DEEP), ("WholeWordMatchSet", DEEP),
    ("ShortestMatchSet", DEEP), ("ShortestMatchSet", ["a" * i + "b" for i in range(40)]),
], ids=["ac", "longest", "whole_word", "shortest", "shortest_deep_inner_ac"])
def test_auto_on_a_deep_dictionary_equals_jax(name, kws):
    """Under ``"auto"`` a dictionary that does not pack inline scans on the
    device (count-packed and hotstate layouts), as the JAX package's does."""
    text = "aaaa the " * 3000 + "a" * 45 + "b aab"
    assert len(text) >= port_matchers._AUTO_DEVICE_MIN_UNITS
    p = getattr(port, name)(kws, device="cpu")
    j = getattr(jax_pkg, name)(kws)
    assert p.match(text) == j.match(text)
    assert p.last_stats.engine == "device"
    assert p.count(text) == j.count(text) > 0
    assert p.last_stats.engine == "device"
    if name == "AhoCorasickSet":
        assert p.count("aaaa the " * 3000) == 33000


def test_auto_engine_threshold():
    kws, _ = _fuzz(9)
    p = port.AhoCorasickSet(kws, device="cpu")
    small = "abc " * 10
    big = "abc " * (port_matchers._AUTO_DEVICE_MIN_UNITS // 4)
    assert p.match(small) == _gold_pairs(p, small)
    assert p.last_stats.engine == "gold"
    assert p.count(big) == len(_gold_pairs(p, big))
    assert p.last_stats.engine == "device"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert port.AhoCorasickSet(["a"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.AhoCorasickSet(["a"])
        with pytest.raises(RuntimeError, match="CUDA"):
            port.AhoCorasickSet(["a"], device="cuda")


@pytest.mark.parametrize("name", ["rowdfa", "batched", "batched2", "pfac2", "rowdfa3"])
@pytest.mark.parametrize("klass", ["AhoCorasickMap", "LongestMatchSet", "WholeWordMatchSet"])
def test_device_engine_knob(klass, name, monkeypatch):
    """The JAX package's ``device_engine`` names are accepted and give the
    JAX matcher's triples under the same knob; any other name raises.
    ``"pfac2"`` takes the PFAC walk (``_candidates_pfac2``), never a planes
    plan; the others never take the walk."""
    kws, text = _fuzz(11, n_text=900)
    args = (kws, list(range(len(kws)))) if klass.endswith("Map") else (kws,)
    p = getattr(port, klass)(*args, engine="device", device="cpu")
    assert p.device_engine == getattr(jax_pkg, klass).device_engine == "rowdfa"
    walks, plans = [], []
    real_walk, real_plan = port_matchers._PfacEngine._candidates_pfac2, port_matchers.dispatch.planes_plan
    monkeypatch.setattr(port_matchers._PfacEngine, "_candidates_pfac2",
                        lambda self, cls: walks.append(1) or real_walk(self, cls))
    monkeypatch.setattr(port_matchers.dispatch, "planes_plan",
                        lambda *a, **k: plans.append(1) or real_plan(*a, **k))
    p.device_engine = name
    if name == "rowdfa3":
        with pytest.raises(ValueError, match="unknown device_engine 'rowdfa3'"):
            p.match_triples(text)
        if klass == "AhoCorasickMap":
            with pytest.raises(ValueError, match="unknown device_engine"):
                p.count(text)
        return
    j = getattr(jax_pkg, klass)(*args, engine="device")
    j.device_engine = name
    got, want = p.match_triples(text), j.match_triples(text)
    assert len(got[0]) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert p.count(text) == j.count(text) == len(got[0])
    assert (len(walks) > 0, len(plans) > 0) == ((True, False) if name == "pfac2" else
                                                (False, True))


def test_version_is_the_jax_packages():
    assert port.__version__ == jax_pkg.__version__
