"""npz artifacts between the two packages, for every kind the port has:
the port saves and both packages load, the JAX package saves and the port
loads; shortest matchers with their internal AC automaton bundled, in a
legacy ``.ac`` sidecar, or missing (the sequential restart scan)."""

import io

import pytest

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import artifact, gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu_torch.models import matchers as port_matchers
from test_torch_host import carry

CLASSES = [
    "AhoCorasickSet", "AhoCorasickMap", "LongestMatchSet", "LongestMatchMap",
    "WholeWordMatchSet", "WholeWordMatchMap", "ShortestMatchSet", "ShortestMatchMap",
    "WholeWordLongestMatchSet", "WholeWordLongestMatchMap",
]
KWS = ["he", "she", "his", "hers", "h", "ushe", "the", "there"]
TEXT = "ushers and she said his hers; there, the he h ushe " * 6


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _make(pkg, name, **kw):
    args = (KWS, [f"v{i}" for i in range(len(KWS))]) if name.endswith("Map") else (KWS,)
    if pkg is port:
        kw.setdefault("device", "cpu")
    return getattr(pkg, name)(*args, engine="device", **kw)


def _gold(m, text):
    vals = m.compiled.values
    if m.is_map:
        return [(s, e, vals[v]) for s, e, v in gold.gold_match(m.compiled, text)]
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


@pytest.mark.parametrize("name", CLASSES)
def test_port_save_loads_in_both_packages(tmp_path, name):
    p = _make(port, name)
    want = p.match(TEXT)
    assert want == _gold(p, TEXT) and len(want) > 10
    path = tmp_path / "m.npz"
    p.save(path)
    pl = port.load_matcher(path, engine="device", device="cpu")
    jl = jax_pkg.load_matcher(path, engine="device")
    assert type(pl).__name__ == type(jl).__name__ == name
    assert pl.match(TEXT) == jl.match(TEXT) == want
    assert pl.last_stats.engine == "device"


@pytest.mark.parametrize("name", CLASSES)
def test_jax_save_loads_in_the_port(tmp_path, name):
    j = _make(jax_pkg, name)
    path = tmp_path / "m.npz"
    j.save(path)
    p = port.load_matcher(path, engine="device", device="cpu")
    assert type(p).__name__ == name
    assert p.match(TEXT) == j.match(TEXT) == _gold(p, TEXT)


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_shortest_bundles_its_ac(tmp_path, is_map):
    name = "ShortestMatchMap" if is_map else "ShortestMatchSet"
    p = _make(port, name)
    p.save(tmp_path / "s.npz")
    compiled, ac = artifact.load_with_ac(tmp_path / "s.npz")
    assert ac is not None and ac.kind == "ac"
    assert artifact.save_bytes(ac) == artifact.save_bytes(p._ac.compiled)
    loaded = port.load_matcher(tmp_path / "s.npz", engine="device", device="cpu")
    assert loaded._ac_cache is not None and loaded.__dict__.get("_src") is None
    assert loaded.match(TEXT) == _gold(loaded, TEXT)
    assert loaded.device_table_bytes() == loaded._ac.device_table_bytes() > 0


def test_shortest_to_a_bytesio_target():
    p = _make(port, "ShortestMatchMap")
    buf = io.BytesIO()
    p.save(buf)
    buf.seek(0)
    loaded = port.load_matcher(buf, engine="device", device="cpu")
    assert loaded._ac_cache is not None
    assert loaded.match(TEXT) == p.match(TEXT) == _gold(p, TEXT)
    buf.seek(0)
    assert jax_pkg.load_matcher(buf, engine="device").match(TEXT) == p.match(TEXT)


def test_shortest_legacy_ac_sidecar(tmp_path):
    j = _make(jax_pkg, "ShortestMatchSet")
    path = tmp_path / "legacy.npz"
    artifact.save(j.compiled, path)  # pre-bundle layout: the AC beside it
    artifact.save(j._ac.compiled, str(path) + ".ac")
    p = port.load_matcher(path, engine="device", device="cpu")
    assert p._ac_cache is not None
    assert p.match(TEXT) == j.match(TEXT) == _gold(p, TEXT)
    p_bytes = port.load_matcher(str(path).encode(), engine="device", device="cpu")
    assert p_bytes._ac_cache is not None


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_shortest_from_compiled_without_ac_takes_the_restart_scan(is_map):
    name = "ShortestMatchMap" if is_map else "ShortestMatchSet"
    values = [f"v{i}" for i in range(len(KWS))] if is_map else None
    compiled = compile_matcher(KWS, "shortest", True, values=values)
    p = getattr(port, name).from_compiled(compiled, engine="device", device="cpu")
    j = getattr(jax_pkg, name).from_compiled(compiled, engine="device")
    assert p._ac is None
    assert p.match(TEXT) == j.match(TEXT) == _gold(p, TEXT)
    assert p.last_stats.engine == "device"
    # The restart scan's tables, padded as the JAX package pads them, and
    # the map from each state to its restart row, built once.
    assert p.device_table_bytes() == j.device_table_bytes() + p.dev.restart_row_id.nbytes > 0
    assert set(p.dev._cache) == {"dfa_next", "match_len", "restart_row_id"}


def test_row_compressed_shortest_artifact_has_no_device_path(tmp_path):
    compiled = compile_matcher(KWS, "shortest", True, thresholder=_NeverDense())
    assert compiled.is_row_compressed
    with pytest.raises(ValueError, match="row-compressed shortest"):
        port.ShortestMatchSet.from_compiled(carry(compiled), engine="device", device="cpu")
    auto = port.ShortestMatchSet.from_compiled(carry(compiled), device="cpu")
    assert auto._pick_engine(1 << 20) == "gold"
    assert auto.match(TEXT) == _gold(auto, TEXT)


def test_whole_word_longest_artifact_names_the_roadmap(tmp_path):
    """A separator-spanning whole-word-longest map (no compiled goto
    closure: the truncated-closure scan) round-trips both ways."""
    kws = KWS + ["she said", "his hers"]
    j = jax_pkg.WholeWordLongestMatchMap(kws, list(range(len(kws))), engine="device")
    j.save(tmp_path / "w.npz")
    p = port.load_matcher(tmp_path / "w.npz", engine="device", device="cpu")
    assert isinstance(p, port.WholeWordLongestMatchMap) and p.compiled.dfa_next is None
    want = j.match(TEXT)
    assert p.match(TEXT) == want == _gold(p, TEXT)
    assert sum(v in (8, 9) for _, _, v in want) == 12
    p.save(tmp_path / "p.npz")
    assert jax_pkg.load_matcher(tmp_path / "p.npz", engine="device").match(TEXT) == want


def test_every_ported_kind_is_registered():
    assert sorted(c.__name__ for c in port_matchers._CLASS_BY_KIND.values()) == sorted(CLASSES)
    assert all(getattr(port, name) is getattr(port_matchers, name) for name in CLASSES)
