"""The lookup probes (B19): each probe of ``ahocorasick_tpu_torch.probes`` (the
kernels' plain twins on the CPU) against the JAX probe of ``tools/probes/``
run in Pallas interpret mode on the same seeded inputs, bit for bit.

The JAX probes draw with the global ``np.random``: a test seeds it, runs the
JAX probe, and hands the port a ``RandomState`` with the same seed, which
draws the same arrays in the same order.  ``pallas_call`` is patched to its
interpret mode, recording each call's output (``probe6``'s ``try_one`` only
prints).  Where the JAX body does not trace (``probe6``'s sublane gather on a
32-column table) the port raises ``ValueError``; the sublane-then-lane 2-D
gathers are held to a numpy statement of their bodies as well as to JAX.
Every output is an integer, so every comparison is exact.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools", "probes"))
import probe as jprobe  # noqa: E402
import probe2 as jprobe2  # noqa: E402
import probe3 as jprobe3  # noqa: E402
import probe6 as jprobe6  # noqa: E402

from ahocorasick_tpu_torch import bench  # noqa: E402
from ahocorasick_tpu_torch.kernels import probes as kp  # noqa: E402
from ahocorasick_tpu_torch.probes import __main__ as probes_main  # noqa: E402
from ahocorasick_tpu_torch.probes import probe, probe2, probe3, probe6  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = dict(device="cpu")


@pytest.fixture
def recorded(monkeypatch):
    """``pallas_call`` in interpret mode; each call's output is appended (as
    numpy) to the returned list."""
    outs = []
    real = pl.pallas_call

    def interpret(kernel, *args, **kw):
        f = functools.partial(real, interpret=True)(kernel, *args, **kw)

        def call(*xs):
            out = f(*xs)
            jax.debug.callback(lambda x: outs.append(np.asarray(x)), out)
            return out

        return call

    monkeypatch.setattr(pl, "pallas_call", interpret)
    return outs


def _jax(seed, fn, *args, **kw):
    np.random.seed(seed)
    rate, out = fn(*args, **kw)
    assert out is not None, "the JAX probe reported UNSUPPORTED"
    return np.asarray(out)


def _port(seed, fn, *args, **kw):
    return fn(*args, rng=np.random.RandomState(seed), **CPU, **kw)[1].numpy()


@pytest.mark.parametrize("placement", kp.PLACEMENTS)
def test_lane_gather(recorded, placement):
    want = _jax(1, jprobe.probe_lane_gather, reps=4, B=8)
    np.testing.assert_array_equal(
        _port(1, probe.probe_lane_gather, reps=4, B=8, placement=placement), want)


@pytest.mark.parametrize("T", [256, 1024])
def test_block_gather(recorded, T):
    want = _jax(2, jprobe.probe_block_gather, T=T, reps=5, B=8)
    np.testing.assert_array_equal(_port(2, probe.probe_block_gather, T=T, reps=5, B=8), want)


@pytest.mark.parametrize("S, K", [(256, 8), (1024, 16)])
def test_scalar_chain(recorded, S, K):
    want = _jax(3, jprobe.probe_scalar_chain, S=S, reps=8, K=K)
    np.testing.assert_array_equal(_port(3, probe.probe_scalar_chain, S=S, reps=8, K=K), want)


def test_row_slice(recorded):
    # Row maxima of a 128-wide draw sit near S; % S wraps them to small states.
    want = _jax(4, jprobe.probe_row_slice, S=300, reps=6, K=4)
    np.testing.assert_array_equal(_port(4, probe.probe_row_slice, S=300, reps=6, K=4), want)


def test_mxu_onehot(recorded):
    want = _jax(5, jprobe.probe_mxu_onehot, T=64, reps=3, B=16)
    np.testing.assert_array_equal(_port(5, probe.probe_mxu_onehot, T=64, reps=3, B=16), want)


def test_flat_gather(recorded):
    want = _jax(6, jprobe.probe_flat_gather, T=1024, reps=4, B=8)
    np.testing.assert_array_equal(_port(6, probe.probe_flat_gather, T=1024, reps=4, B=8), want)


@pytest.mark.parametrize("T", [256, 1024])
def test_block_gather_sustained(recorded, T):
    want = _jax(7, jprobe2.probe_block_gather_sustained, T, 6, B=8)
    np.testing.assert_array_equal(_port(7, probe2.probe_block_gather_sustained, T, 6, B=8), want)


def test_sublane_gather(recorded):
    want = _jax(8, jprobe2.probe_sublane_gather)
    np.testing.assert_array_equal(_port(8, probe2.probe_sublane_gather), want)


def _gather2d_numpy(tab, idx, reps, T, first_only, add_r):
    """The sublane-then-lane gather body: per 8-row tile, g1[i, j] =
    tab[sub[i, j], j], then out[i, j] = g1[i, lane[i, j]]."""
    idx = idx.astype(np.int64)
    rows = 8 if first_only else idx.shape[0]
    for r in range(reps):
        acc = np.zeros_like(idx)
        for base in range(0, rows, 8):
            sub = (idx[base: base + 8] >> 7) & 7
            lane = idx[base: base + 8] & 127
            g1 = np.take_along_axis(tab.astype(np.int64), sub, axis=0)
            acc[base: base + 8] = np.take_along_axis(g1, lane, axis=1)
        idx = (idx + acc + (r if add_r else 0)) & (T - 1)
    return idx


def test_gather2d_first_tile(recorded):
    """probe2.py:86, rows 0-7 gathered and every row masked: == the JAX
    probe (which traces in interpret mode here) and == numpy."""
    want = _jax(9, jprobe2.probe_gather2d, T=1024, reps=5, B=16)
    got = _port(9, probe2.probe_gather2d, T=1024, reps=5, B=16)
    rs = np.random.RandomState(9)
    tab, idx = rs.randint(0, 1024, (8, 128), np.int32), rs.randint(0, 1024, (16, 128), np.int32)
    np.testing.assert_array_equal(got, _gather2d_numpy(tab, idx, 5, 1024, True, False))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make, args", [("make_lane_gather", (8,)),
                                        ("make_block_gather", (1024, 8)),
                                        ("make_gather2d", (16,))])
def test_make_pairs(recorded, make, args):
    """probe3's summed probes, both ``mk`` calls (each draws afresh)."""
    np.random.seed(10)
    mk_j = getattr(jprobe3, make)(*args)
    want = [int(f(*a)) for f, a in (mk_j(3), mk_j(7))]
    mk_p = getattr(probe3, make)(*args, rng=np.random.RandomState(10), **CPU)
    got = [int(f(*a)) for f, a in (mk_p(3), mk_p(7))]
    assert got == want
    if make == "make_gather2d":  # probe3.py:142: every tile, + r, int32 sum
        rs = np.random.RandomState(10)
        sums = []
        for reps in (3, 7):
            tab, idx = rs.randint(0, 1024, (8, 128), np.int32), rs.randint(0, 1024, (16, 128),
                                                                          np.int32)
            sums.append(int(_gather2d_numpy(tab, idx, reps, 1024, False, True).sum()))
        assert got == sums


def test_pallas_gathers(recorded, capsys):
    """probe6.py:120 at a 512 x 32 table: the flat, take and row
    formulations == the JAX kernels' recorded outputs; the sublane one fails
    in both (JAX by shape, the port with ValueError)."""
    jprobe6.probe_pallas_gathers(S=512, A=32, T=8)
    assert "FAIL" in capsys.readouterr().out.splitlines()[-1]
    firsts = recorded[::5]  # _timeit runs each kernel 5 times
    assert len(recorded) == 15 and len(firsts) == 3
    got = probe6.probe_pallas_gathers(S=512, A=32, T=8, **CPU)
    names = list(got)
    for name, want in zip(names[:3], firsts):
        np.testing.assert_array_equal(got[name][1].numpy(), want, err_msg=name)
    assert isinstance(got[names[3]], ValueError)


def test_sublane_chain_wide_table(recorded):
    """probe6.py:162 where it is defined (128 columns): == JAX's recorded
    output and == numpy ``s <- (small[s % 8, j] + s) % 8``."""
    S, A, T = 64, 128, 8
    jprobe6.probe_pallas_gathers(S=S, A=A, T=T)
    assert len(recorded) == 20
    got = probe6.probe_pallas_gathers(S=S, A=A, T=T, **CPU)
    name = list(got)[3]
    rng = np.random.default_rng(0)
    small = rng.integers(0, S * A, size=(S * A,), dtype=np.int64).astype(np.uint32)
    small = small.reshape(S, A)[0:8, 0:128].astype(np.int64)
    s = rng.integers(0, S, size=(8, 128)).astype(np.int64) % 8
    for _ in range(T):
        s = (np.take_along_axis(small, s % 8, axis=0) + s) % 8
    np.testing.assert_array_equal(got[name][1].numpy(), s)
    np.testing.assert_array_equal(got[name][1].numpy(), recorded[15])


@pytest.mark.parametrize("op", ["load", "load_mod", "add_r"])
def test_chain_ops_against_numpy(op):
    rs = np.random.RandomState(11)
    T = 512
    tab, idx = rs.randint(0, T, T, np.int32), rs.randint(0, T, 40, np.int32)
    mod = 300 if op == "load_mod" else None
    i = idx.astype(np.int64)
    for r in range(9):
        v = tab[np.minimum(i, T - 1) if op != "add_r" else i & (T - 1)]
        i = v if op == "load" else v % 300 if op == "load_mod" else (i + v + r) & (T - 1)
    got = kp.chain_gather(torch.from_numpy(tab), torch.from_numpy(idx), 9, op, mod=mod)
    np.testing.assert_array_equal(got.numpy(), i)
    total = kp.chain_gather(torch.from_numpy(tab), torch.from_numpy(idx), 9, op, mod=mod,
                            sum_out=True)
    assert int(total) == int(i.sum())


def test_wrappers_refuse_what_the_kernels_cannot_take():
    small = torch.zeros(128, dtype=torch.int32)
    big = torch.zeros(kp.SHARED_BYTES // 4 + 1, dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        kp.chain_gather(big, idx, 1, "load", placement="shared")
    kp.chain_gather(big[: kp.SHARED_BYTES // 4], idx, 1, "load", placement="shared")
    with pytest.raises(ValueError, match="128 entries"):
        kp.chain_gather(torch.zeros(256, dtype=torch.int32), idx, 1, "add", placement="shfl")
    with pytest.raises(ValueError, match="power of two"):
        kp.chain_gather(small[:100], idx, 1, "add")
    with pytest.raises(ValueError, match="mod"):
        kp.chain_gather(small, idx, 1, "load_mod", mod=129)
    with pytest.raises(ValueError, match="placement"):
        kp.chain_gather(small, idx, 1, "load", placement="vmem")
    assert kp.default_placement(128) == "shared"
    assert kp.default_placement(kp.SHARED_BYTES // 4) == "shared"
    assert kp.default_placement(kp.SHARED_BYTES // 4 + 1) == "global"


@pytest.mark.parametrize("bad", [2048.0, 2.5, -1.0])
def test_onehot_refuses_values_fp16_cannot_hold(bad):
    tab = torch.zeros((64, 32), dtype=torch.float32)
    tab[3, 5] = bad
    with pytest.raises(ValueError, match="integers in"):
        kp.onehot_table(tab)


def test_residency_sweep_records():
    recs = probes_main.residency_sweep(torch.device("cpu"), sizes=(128, 4096), chains=64,
                                       steps=4, reps=1, calls=2)
    got = [(r["entries"], r["placement"]) for r in recs]
    assert got == [(128, "shfl"), (128, "shared"), (128, "global"), (128, "row_chain"),
                   (128, "torch"), (4096, "shared"), (4096, "global"), (4096, "row_chain"),
                   (4096, "torch")]
    assert all(r["ms"] > 0 and r["rate"] > 0 and r["max_abs_err"] == 0 for r in recs)
    tab = probes_main.cycle_table(1000, "cpu", torch.Generator().manual_seed(0))
    seen, s = set(), 0
    for _ in range(1000):
        seen.add(s)
        s = int(tab[s])
    assert len(seen) == 1000 and s == 0  # one cycle through every entry


def test_best_pair_is_the_headlines_differencing():
    calls = iter([5.0, 1.0, 4.0, 2.0, 6.0, 0.5])
    lo, hi = bench._best_pair(lambda: next(calls), lambda: next(calls))
    assert (lo, hi) == (0.5, 4.0)
    calls = iter([5.0, 1.0, 4.0, 2.0])
    assert bench._best_pair(lambda: next(calls), lambda: next(calls),
                            stop=lambda pair: True) == (1.0, 5.0)


def test_main_on_the_cpu_finishes_in_seconds():
    proc = subprocess.run([sys.executable, "-m", "ahocorasick_tpu_torch.probes", "--platform",
                           "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for head in ("== probe ==", "== probe2 ==", "== probe3 ==", "== probe6 ==",
                 "== residency sweep =="):
        assert head in out
    assert out.count("M lookups/s") >= 20 and out.count("\nsweep ") == 3
    assert "sublane take_along_axis (8,128)    FAIL" in out
