"""The big-table locality probe (``probe7``) on the CPU against the JAX probe
of ``tools/probes/probe7.py``.

What each test compares:

* ``_hash`` and ``_windows``: the port's values (int64 holding uint32)
  against the JAX uint32 arrays, byte for byte, ``_hash`` up to 2**32 - 1;
* parts B and C: ``timeit_traced`` patched in both modules to record
  ``fn(*args_lo)``, the int32 sum over ``reps_lo`` reps of every window's
  chain, with ``B_LANES`` and ``CHUNK`` patched small on both and small
  tables; part B at every n of its list (1, 4,096, 65,536, 2**20 and the
  rows: next states past the table's rows are clamped, flat by the index,
  2-D by the row and the column, as XLA clamps), both flavors; part C at two
  sizes.  The port runs ``window_chain``'s twin;
* part A: the table the JAX ``fn`` builds (recorded from inside its
  ``rowdfa1_count`` call) against the port's ``part_a_table``, byte for byte,
  and the port's count (``packed_scan_count``'s twin) against JAX's
  ``rowdfa1_count`` at a body of 64 classes, where ``scan_block.segments``
  gives one lane a window: only there is the kernel's lane split exact on
  the hashed table, which does not synchronize (at the probe's 512 the
  kernel runs K = 4 lanes a window and its count differs).

Every value is an integer: exact equality.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools", "probes"))
import probe7 as jprobe7  # noqa: E402

from ahocorasick_tpu.ops import scan_rowdfa as jscan_rowdfa  # noqa: E402
from ahocorasick_tpu_torch.kernels import scan_block  # noqa: E402
from ahocorasick_tpu_torch.probes import probe7  # noqa: E402


def _u32(t: torch.Tensor) -> np.ndarray:
    """A port tensor (int64 holding uint32, or int32 / uint32 words) as uint32."""
    if t.dtype == torch.int64:
        return t.numpy().astype(np.uint32)
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.fixture
def small(monkeypatch):
    """B_LANES and CHUNK cut on both modules; each module's ``timeit_traced``
    records ``int(fn(*args_lo))`` instead of timing."""
    got = {"jax": [], "port": []}
    for mod, key in ((jprobe7, "jax"), (probe7, "port")):
        monkeypatch.setattr(mod, "B_LANES", 16)
        monkeypatch.setattr(mod, "CHUNK", 64)
        monkeypatch.setattr(mod, "timeit_traced",
                            lambda fn, a_lo, *rest, _k=key: got[_k].append(int(fn(*a_lo))))
    return got


def test_hash_matches_jax():
    i = np.concatenate([np.arange(70000), (1 << 32) - 1 - np.arange(5000),
                        np.random.default_rng(0).integers(0, 1 << 32, 20000)]).astype(np.uint32)
    want = np.asarray(jprobe7._hash(jnp.asarray(i)))
    got = _u32(probe7._hash(torch.from_numpy(i.astype(np.int64))))
    assert got.tobytes() == want.tobytes()


def test_windows_match_jax(small):
    for shift in (1, 7):
        want = np.asarray(jprobe7._windows(shift))
        got = probe7._windows(shift, "cpu")
        assert got.dtype == torch.int32 and got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("flavor", ["flat", "2d"])
def test_part_b_chain_sums_match_jax(flavor, small):
    jprobe7.part_b(flavor, 512)
    probe7.part_b(flavor, 512, device="cpu")
    assert len(small["jax"]) == 5 and small["port"] == small["jax"]
    assert small["jax"][0] == 0  # n = 1: every next state is 0


def test_part_c_chain_sums_match_jax(small):
    jprobe7.part_c([256, 1000])
    probe7.part_c([256, 1000], device="cpu")
    assert len(small["jax"]) == 2 and small["port"] == small["jax"]


def test_part_a_table_and_count_match_jax(small, monkeypatch):
    tables = []
    real = jscan_rowdfa.rowdfa1_count

    def recording(table, windows, halo, state_bits, num_classes):
        jax.debug.callback(lambda t: tables.append(np.asarray(t)) if not tables else None, table)
        return real(table, windows, halo, state_bits, num_classes)

    monkeypatch.setattr(jscan_rowdfa, "rowdfa1_count", recording)
    jprobe7.part_a([1])
    probe7.part_a([1], device="cpu")
    table, S, sb = probe7.part_a_table(1, 1, "cpu")
    assert (S, sb) == (8192, 13) and len(tables) == 1
    assert _u32(table).tobytes() == tables[0].tobytes()
    assert scan_block.segments(16, 64, probe7.HALO, scan_block.COUNT_MAX_LANES)[0] == 1
    assert small["jax"][0] > 0 and small["port"] == small["jax"]
