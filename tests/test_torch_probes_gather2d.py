"""The probes' 2-D gather in its warp-row form (``csrc/gather2d.cuh``): a
numpy model of what each warp computes, held against the wrapper's plain
twin (``kernels.probes.gather2d_plain``) and against the JAX probes
``probe2.probe_gather2d`` (the first tile) and ``probe3.make_gather2d``
(every tile, summed) run with ``pallas_call`` in interpret mode, as
``tests/test_torch_probes.py`` runs them; and the launch-shape rule
``gather2d_shape``.

The model: row i of idx is warp i; lane l owns columns l + 32 q (q = 0..3)
and reads their table words tab[s][l + 32 q] from the block's shared copy;
a step computes the sublane gather g1 for the lane's own columns, writes
them to the warp's row in shared memory (double-buffered by the step's
parity), and reads g1 at column L = x & 127, which lane L & 31 wrote from
its slot L >> 5.  Rows past the first tile of ``gather2d_first`` are masked once
where reps >= 1.  With ``sum_out`` each warp reduces its lanes and each
block of ``gather2d_shape`` warps adds once, wrapping as an int32 sum.
Every value is an integer, so every comparison is exact.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools", "probes"))
import probe2 as jprobe2  # noqa: E402
import probe3 as jprobe3  # noqa: E402

from ahocorasick_tpu_torch.kernels import probes as kp  # noqa: E402

M = 0xFFFFFFFF


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


def lanes(a: np.ndarray) -> np.ndarray:
    """(rows, 128) -> (rows, 32 lanes, 4 slots): lane l, slot q holds column
    l + 32 q."""
    return a.reshape(a.shape[0], 4, 32).transpose(0, 2, 1)


def columns(a: np.ndarray) -> np.ndarray:
    """The inverse of ``lanes``."""
    return a.transpose(0, 2, 1).reshape(a.shape[0], 128)


def exchange(g1: np.ndarray, L: np.ndarray, r: int, rows_buf: np.ndarray):
    """Each lane's value of g1 at column L of its row, through the warp's
    row: ``g1`` (rows, 32, 4), ``L`` (rows, 32, 4)."""
    buf = rows_buf[:, r & 1]  # (rows, 128), written then read after one __syncwarp
    buf[:] = columns(g1)
    return np.take_along_axis(buf, L.reshape(L.shape[0], -1), axis=1).reshape(L.shape)


def warp_rows(tab, idx, reps, mode, mask=0, sum_out=False):
    """The kernel's result in numpy, warp by warp (uint32 words as int64)."""
    tab = np.asarray(tab).astype(np.int64) & M
    x = lanes(np.asarray(idx).astype(np.int64) & M)
    q = np.arange(4)[None, None, :]
    lane = np.arange(32)[None, :, None]

    def at(s):  # the shared copy's word s * 128 + lane + 32 q
        return tab.reshape(-1)[s * 128 + lane + 32 * q]

    rows = x.shape[0]
    if mode == "sublane":
        x = at(x & 7)
    elif mode == "sublane_chain":
        # bits 3 s .. 3 s + 2 of a lane's steering word: tab[s][j] & 7, all
        # that a step of the chain reads
        own = np.stack([tab[s][lane + 32 * q][0] for s in range(8)])  # (8, 32, 4)
        steer = sum((own[s] & 7) << (3 * s) for s in range(8))  # (32, 4)
        x = x & 7
        for _ in range(reps):
            x = ((steer[None] >> (3 * x)) + x) & 7
    else:
        live = rows if mode == "gather2d_all" else 8
        buf = np.zeros((live, 2, 128), dtype=np.int64)
        y = x[:live]
        for r in range(reps):
            v = exchange(at((y >> 7) & 7), y & 127, r, buf)
            y = (y + v + (r if mode == "gather2d_all" else 0)) & mask
        x = np.concatenate([y, x[live:] & mask if reps else x[live:]])
    if not sum_out:
        return columns(x)
    warps, blocks = kp.gather2d_shape(rows, mode)
    per_warp = x.sum(axis=(1, 2)) & M  # __reduce_add_sync over the lanes' four-word sums
    per_block = np.add.reduceat(per_warp, np.arange(0, rows, warps)) & M
    return int(per_block.sum() & M)


def _plain(tab, idx, reps, mode, mask=0, sum_out=False):
    got = kp.gather2d_plain(torch.from_numpy(np.asarray(tab, np.uint32).view(np.int32)),
                            torch.from_numpy(np.asarray(idx, np.uint32).view(np.int32)), reps,
                            mode, mask=mask, sum_out=sum_out)
    return int(got) & M if sum_out else got.numpy().view(np.uint32).astype(np.int64)


def _draw(rng, shape):
    return np.where(rng.random(shape) < 0.5, rng.integers(0, 1024, shape),
                    rng.integers(0, 1 << 32, shape)).astype(np.uint32)


@pytest.mark.parametrize("mode", kp.G2_MODES)
@pytest.mark.parametrize("B", [8, 16, 64])
def test_model_equals_twin(mode, B):
    """Every mode at 8, 16 and 64 rows, reps 0, 1, 2 and 7, masks 0, 1,023
    and 2**32 - 1, both outputs."""
    rng = np.random.default_rng(B)
    tab, idx = _draw(rng, (8, 128)), _draw(rng, (B, 128))
    masks = (0, 1023, M) if mode.startswith("gather2d") else (0,)
    for reps in (0, 1, 2, 7):
        for mask in masks:
            want = _plain(tab, idx, reps, mode, mask)
            np.testing.assert_array_equal(warp_rows(tab, idx, reps, mode, mask), want)
            assert warp_rows(tab, idx, reps, mode, mask, True) == \
                _plain(tab, idx, reps, mode, mask, True)


def test_first_tile_with_no_steps_leaves_every_row():
    """``gather2d_first`` at reps 0: no row is masked, not even past the
    first tile (the JAX fori_loop runs no step); at reps 1 every row past it
    is masked once."""
    rng = np.random.default_rng(3)
    tab, idx = _draw(rng, (8, 128)), _draw(rng, (24, 128))
    np.testing.assert_array_equal(warp_rows(tab, idx, 0, "gather2d_first", 1023),
                                  idx.astype(np.int64))
    got = warp_rows(tab, idx, 1, "gather2d_first", 1023)
    np.testing.assert_array_equal(got[8:], idx[8:].astype(np.int64) & 1023)
    np.testing.assert_array_equal(got, _plain(tab, idx, 1, "gather2d_first", 1023))


def test_double_buffer_holds_the_step_a_slow_lane_reads():
    """The warp row's two buffers: a lane that runs a step ahead writes the
    other buffer, so a lane still at step r reads step r's g1, the value
    lane L & 31 wrote from its slot L >> 5.  With one buffer the fast lane's
    step r + 1 would overwrite it."""
    rng = np.random.default_rng(4)
    tab, idx = _draw(rng, (8, 128)), rng.integers(0, 1024, (8, 128)).astype(np.uint32)
    x = lanes(idx.astype(np.int64))
    own_g1 = lambda y: tab.astype(np.int64)[(y >> 7) & 7, np.arange(128)[None, :]]  # noqa: E731
    g1_r = lanes(own_g1(columns(x)))
    rows = np.arange(8)[:, None, None]
    sent = g1_r[rows, (x & 127) & 31, (x & 127) >> 5]  # lane L & 31, slot L >> 5
    buf = np.zeros((8, 2, 128), dtype=np.int64)
    np.testing.assert_array_equal(exchange(g1_r, x & 127, 0, buf), sent)
    y = (x + sent) & 1023
    g1_next = lanes(own_g1(columns(y)))
    buf[:, 1] = columns(g1_next)  # a fast lane's step 1 writes the other buffer
    np.testing.assert_array_equal(buf[:, 0][rows, x & 127], sent)
    assert not np.array_equal(buf[:, 1][rows, x & 127], sent)


def test_first_tile_equals_jax(recorded):
    """probe2.py:86 (rows 0-7 gathered, every row masked) == the model."""
    np.random.seed(9)
    _, out = jprobe2.probe_gather2d(T=1024, reps=5, B=16)
    rs = np.random.RandomState(9)
    tab, idx = rs.randint(0, 1024, (8, 128), np.int32), rs.randint(0, 1024, (16, 128), np.int32)
    np.testing.assert_array_equal(warp_rows(tab, idx, 5, "gather2d_first", 1023),
                                  np.asarray(out))


@pytest.mark.parametrize("B", [16, 32])
def test_every_tile_summed_equals_jax(recorded, B):
    """probe3.py:142 (every tile, + r, an int32 sum) == the model, both ``mk``
    calls (each draws afresh)."""
    np.random.seed(10 + B)
    mk = jprobe3.make_gather2d(B)
    want = [int(f(*a)) & M for f, a in (mk(3), mk(6))]
    rs = np.random.RandomState(10 + B)
    got = []
    for reps in (3, 6):
        tab, idx = rs.randint(0, 1024, (8, 128), np.int32), rs.randint(0, 1024, (B, 128), np.int32)
        got.append(warp_rows(tab, idx, reps, "gather2d_all", 1023, True))
    assert got == want


def test_sublane_equals_jax(recorded):
    """probe2.py:56's sublane gather (tab[idx & 7, j], once) == the model."""
    np.random.seed(8)
    _, out = jprobe2.probe_sublane_gather()
    rs = np.random.RandomState(8)
    tab, idx = rs.randint(0, 100, (8, 128), np.int32), rs.randint(0, 8, (8, 128), np.int32)
    np.testing.assert_array_equal(warp_rows(tab, idx, 1, "sublane"), np.asarray(out))


@pytest.mark.parametrize("rows", [8, 16, 64, 128, 256, 264, 512, 1056, 4096, 8192])
@pytest.mark.parametrize("mode", kp.G2_MODES)
def test_launch_shape(rows, mode):
    """At most ``G2_MAX_WARPS`` rows a block, a power of two; every row
    covered once, and no block without a row.  The single sublane gather:
    ``G2_MAX_WARPS`` rows a block, a thread an index (a word of the table a
    thread).  The chains, a warp a row: blocks for every SM wherever the
    rows allow, and as many rows a block as that leaves."""
    warps, blocks = kp.gather2d_shape(rows, mode)
    assert warps & (warps - 1) == 0 and 1 <= warps <= kp.G2_MAX_WARPS
    assert blocks * warps >= rows > (blocks - 1) * warps
    if mode == "sublane":
        assert warps == kp.G2_MAX_WARPS and 128 * warps == 1024
    elif rows >= kp.SM_COUNT:
        assert blocks >= kp.SM_COUNT
        assert warps == kp.G2_MAX_WARPS or -(-rows // (2 * warps)) < kp.SM_COUNT
    else:
        assert warps == 1
    assert kp.gather2d_shape(512) == (2, 256)


def test_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the wrapper returns the twin, 4 bytes off a 16-byte
    boundary too, and launches nothing."""
    from ahocorasick_tpu_torch.kernels.build import launches

    rng = np.random.default_rng(5)
    tab = torch.from_numpy(_draw(rng, (8, 128)).view(np.int32))
    flat = torch.from_numpy(_draw(rng, (16 * 128 + 1,)).view(np.int32))
    idx = flat[1:].view(16, 128)
    before = launches["gather2d"]
    for mode in kp.G2_MODES:
        got = kp.gather2d(tab, idx, 3, mode, mask=1023)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      warp_rows(tab.numpy().view(np.uint32),
                                                idx.numpy().view(np.uint32), 3, mode, 1023))
    assert launches["gather2d"] == before
