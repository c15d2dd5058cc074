"""Chunk stitching in the port (CPU tensors: the kernels' plain twins) vs the
JAX package's ``ops/stitch.py`` on the tables and chunk sizes of
``tests/test_stitch.py``.  Everything compared is an integer, so every
comparison is exact."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as act
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.ops import stitch as jax_stitch
from ahocorasick_tpu_torch.kernels import stitch as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_dfa as port_scan_dfa
from ahocorasick_tpu_torch.ops import stitch as port_stitch


def _setup(kind):
    """(JAX table, classes) of ``test_stitch.py``'s AC or Shortest case."""
    if kind == "ac":
        rng = random.Random(3)
        text = "".join(rng.choice("abc") for _ in range(256))
        m = act.AhoCorasickSet(["ab", "abc", "bca", "c", "ca"], True, engine="device")
        table = m.dev.dfa_next
    else:
        rng = random.Random(4)
        text = "".join(rng.choice("abc") for _ in range(128))
        m = act.ShortestMatchSet(["aaa", "ab", "bc"], True, engine="device")
        table = m.dev.dfa_next_shortest
    cls = m.compiled.charmap[act.chartables.to_utf16_units(text)].astype(np.int32)
    return m, np.asarray(table), cls


CASES = [("ac", c) for c in (1, 3, 8, 64)] + [("shortest", c) for c in (4, 32)]


@pytest.mark.parametrize("kind, chunk", CASES)
@pytest.mark.parametrize("s0", [0, 2])
def test_each_stage_equals_jax(kind, chunk, s0):
    m, table, cls = _setup(kind)
    chunks = np.pad(cls, (0, (-len(cls)) % chunk)).reshape(-1, chunk)
    jt, jc = jnp.asarray(table), jnp.asarray(chunks)
    pt, pc = torch.from_numpy(table.copy()), torch.from_numpy(chunks)
    before = dict(launches)

    want_sigma = np.asarray(jax_stitch.chunk_state_maps(jt, jc))
    got_sigma = port_stitch.chunk_state_maps(pt, pc)
    assert got_sigma.dtype == torch.int32 and tuple(got_sigma.shape) == want_sigma.shape
    np.testing.assert_array_equal(got_sigma.numpy(), want_sigma)

    want_entry = np.asarray(jax_stitch.entry_states(jnp.asarray(want_sigma), s0))
    got_entry = port_stitch.entry_states(got_sigma, s0)
    assert got_entry.dtype == torch.int32
    np.testing.assert_array_equal(got_entry.numpy(), want_entry)

    want_states = np.asarray(jax_stitch.stitched_states(jt, jc, jnp.asarray(want_entry)))
    got_states = port_stitch.stitched_states(pt, pc, got_entry)
    assert got_states.dtype == torch.int32
    np.testing.assert_array_equal(got_states.numpy(), want_states)

    want_scan = np.asarray(jax_stitch.stitched_scan(jt, jc, s0))
    got_scan = port_stitch.stitched_scan(pt, pc, s0)
    np.testing.assert_array_equal(got_scan.numpy(), want_scan)
    # ... which is the port's one sequential scan from s0.
    flat = port_scan_dfa.dfa_states(pt, pc.reshape(-1), s0)
    np.testing.assert_array_equal(got_scan.reshape(-1).numpy(), flat.numpy())
    assert launches == before  # the twins count no launches


def test_shortest_table_stitch_equals_the_restart_scan():
    m, table, cls = _setup("shortest")
    chunks = torch.from_numpy(np.pad(cls, (0, (-len(cls)) % 32)).reshape(-1, 32))
    got = port_stitch.stitched_scan(torch.from_numpy(table.copy()), chunks)
    want = np.asarray(jax_scan_dfa.shortest_states(m.dev.dfa_next, m.dev.match_len,
                                                   jnp.asarray(cls)))
    np.testing.assert_array_equal(got.reshape(-1).numpy()[: len(cls)], want)


def test_zero_chunks_and_identity_maps():
    _, table, _ = _setup("ac")
    empty = np.zeros((0, 7), dtype=np.int32)
    want = np.asarray(jax_stitch.stitched_scan(jnp.asarray(table), jnp.asarray(empty)))
    got = port_stitch.stitched_scan(torch.from_numpy(table.copy()), torch.from_numpy(empty))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (0, 7)
    # Identity maps compose to s0 everywhere (test_stitch.py's hand check).
    sigma = torch.from_numpy(np.tile(np.arange(5, dtype=np.int32), (4, 1)))
    assert port_stitch.entry_states(sigma).tolist() == [0, 0, 0, 0]
    assert port_stitch.entry_states(sigma, 3).tolist() == [3, 3, 3, 3]
    # Zero-length chunks: every map is the identity.
    t = torch.from_numpy(table.copy())
    ident = kernels.state_maps(t, torch.zeros((3, 0), dtype=torch.int32))
    assert ident.tolist() == [list(range(table.shape[0]))] * 3
    assert tuple(kernels.rescan(t, torch.zeros((3, 0), dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32)).shape) == (3, 0)


def test_wrappers_reject_bad_inputs():
    _, table, cls = _setup("ac")
    t = torch.from_numpy(table.copy())
    c = torch.from_numpy(cls[:64].reshape(8, 8))
    with pytest.raises(TypeError):
        kernels.state_maps(t.to(torch.int64), c)
    with pytest.raises(TypeError):
        kernels.state_maps(t, c.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.state_maps(t, c.t())
    sigma = kernels.state_maps(t, c)
    with pytest.raises(ValueError, match="entry state"):
        kernels.entry_fold(sigma, table.shape[0])
    with pytest.raises(ValueError, match="entry states for"):
        kernels.rescan(t, c, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.rescan(t, c, torch.zeros(8, dtype=torch.int64))
