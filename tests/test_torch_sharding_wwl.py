"""Whole-word-longest through the port's sharded scanner (CPU devices: the
kernels' plain twins) vs the JAX package's on its virtual CPU mesh and vs
gold: both branches of ``sharded_wwl_walks`` (the per-shard scan with its
every-position sweep, and the per-start walk), pure, mixed and quotient
dictionaries, and ``wwl_scan_walks_all`` on JAX-built tables in both table
layouts.  Everything compared is an integer, so every comparison is exact."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

import ahocorasick_tpu as act
from ahocorasick_tpu.ops import scan_wwl as jax_wwl
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_sharding import CPU, _check, _check_walks, _np, _pair
from test_torch_wwl import _build, _dictionary


def _fuzz_case(trial):
    r = random.Random(500 + trial)
    pool = ["a", "b", "ab", "ba", "aab", " ", "!!", "bab"]
    kws = list({r.choice(pool) for _ in range(r.randint(1, 6))})
    return kws, "".join(r.choice("ab !") for _ in range(r.randint(0, 4000)))


@pytest.mark.parametrize("trial", range(25))
def test_sharded_wwl_scan_engine_fuzz(trial):
    kws, t = _fuzz_case(trial)
    jm, pm = _pair("WholeWordLongestMatchSet", kws, engine="auto")
    assert port_wwl.scan_applicable(pm.compiled)
    # The raw outcomes equal JAX's and both packages follow the chain with
    # the same host code, so JAX's triples are asked for every fifth trial.
    _check(jm, pm, t, 8, jax_triples=trial % 5 == 0)
    _check_walks(jm, pm, t, 8)


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("branch", ["scan", "walk"])
def test_sharded_wwl_fuzz_uneven_worlds(branch, w, monkeypatch):
    if branch == "walk":
        for mod in (jax_wwl, port_wwl):
            monkeypatch.setattr(mod, "scan_applicable", lambda m: False)
            monkeypatch.setattr(mod, "mixed_scan_applicable", lambda m: False)
    kws, t = _fuzz_case(4)
    jm, pm = _pair("WholeWordLongestMatchMap", kws, list(range(len(kws))), engine="auto")
    _check(jm, pm, t, w, with_vals=True)
    _check_walks(jm, pm, t, w)


@pytest.mark.parametrize("trial", [0, 7, 16])
def test_sharded_wwl_walk_branch(trial, monkeypatch):
    for mod in (jax_wwl, port_wwl):
        monkeypatch.setattr(mod, "scan_applicable", lambda m: False)
        monkeypatch.setattr(mod, "mixed_scan_applicable", lambda m: False)
    kws, t = _fuzz_case(trial)
    jm, pm = _pair("WholeWordLongestMatchSet", kws, engine="auto")
    _check(jm, pm, t, 8)
    _check_walks(jm, pm, t, 8)
    short = t[:5]  # fewer units than shards: chunk = d + 1
    _check(jm, pm, short, 8)
    _check_walks(jm, pm, short, 8)


@pytest.mark.parametrize("trial", range(10))
def test_sharded_wwl_mixed(trial):
    jm, pm = _pair("WholeWordLongestMatchSet", ["new york", "new", "york", "a b", "ab"],
                   case_sensitive=False)
    assert port_wwl.mixed_scan_applicable(pm.compiled)
    rng = random.Random(590 + trial)
    t = "".join(rng.choice(["new", "york", " ", "a", "b ", "!x"])
                for _ in range(rng.randint(0, 3000)))
    _check(jm, pm, t, 8, jax_triples=trial % 5 == 0)
    cont = _check_walks(jm, pm, t, 8)[5]
    assert cont is not None and cont.dtype == bool


@pytest.fixture(params=[False, True], ids=["row", "flat"])
def layout(request, monkeypatch):
    """Both packages' row-layout gate, or the flat layout forced in both."""
    if request.param:
        monkeypatch.setattr(jax_wwl, "_ROW_MAX_BYTES", 0)
        monkeypatch.setattr(port_wwl, "_ROW_MAX_BYTES", 0)
    return request.param


@pytest.mark.parametrize("name", ["dense", "quirk", "fullnode", "quotient", "mixed",
                                  "mixed_quotient"])
def test_scan_walks_all_twin_equals_jax(name, layout):
    """``wwl_scan_walks_all`` on JAX-built tables: pure, mixed and quotient."""
    m, text = _dictionary(name)
    host = _build(jax_wwl, m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    d = port_wwl.bucket_depth(m.max_depth)
    cw = port_sh._chunk_for(d + 1, 512)
    cls = m.charmap[act.chartables.to_utf16_units(text)][: 2 * cw + 100]
    n_keep = -(-len(cls) // cw) * cw
    # [d-unit left halo | n_keep | cw-unit right halo], as a shard builds it.
    region = np.pad(cls, (d, n_keep - len(cls) + cw))
    windows = np.asarray(jax_sh._windows_on_device(jnp.asarray(region), cw, d))
    kw = dict(halo=d, id_bits=host.id_bits, depth_bits=host.depth_bits,
              num_classes=host.num_classes, d=d, row_layout=host.row_layout,
              quotient=host.quotient, n_keep=n_keep, cross=host.has_cross)
    want = jax_wwl.wwl_scan_walks_all(
        jnp.asarray(host.table), None if host.rows_flat is None else jnp.asarray(host.rows_flat),
        jnp.asarray(host.outrows), jnp.asarray(windows.astype(np.int32)), **kw)
    before = dict(launches)
    got = port_wwl.wwl_scan_walks_all(
        sc.table, sc.rows_flat, sc.outrows,
        port_sb.classes_to_device(windows, host.num_classes, CPU), **kw)
    assert len(got) == len(want) == (6 if host.has_cross else 5)
    for w, g in zip(want, got):
        assert _np(g).dtype == np.asarray(w).dtype and len(g) == n_keep
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert launches == before
    with pytest.raises(ValueError, match="n_keep"):
        port_wwl.wwl_scan_walks_all(
            sc.table, sc.rows_flat, sc.outrows,
            port_sb.classes_to_device(windows, host.num_classes, CPU),
            **{**kw, "n_keep": windows.shape[0] * cw - d})
