"""Differenced timing of the lane, block and 2-D gathers — the port of
``tools/probes/probe3.py``.

Each ``make_*`` returns ``mk(reps) -> (fn, args)``: ``fn(*args)`` runs
``reps`` chained steps on the kernel and returns the int32 sum of the final
indices (the JAX probes' (1, 1) SMEM output), drawing its inputs afresh for
each ``mk`` call, as the JAX ``mk`` does.  ``timeit2`` times ``mk(lo)`` and
``mk(hi)`` on the same inputs and takes the rate from the difference
(``bench._best_pair``), cancelling each call's fixed cost: the card's time
alone (``card_seconds``), since a call of few reps takes the host longer
to launch than the card to run.  The JAX file's
XLA gathers are the library yardstick here (``make_torch_*``).
"""

from __future__ import annotations

import numpy as np
import torch

from ahocorasick_tpu_torch.bench import _best_pair
from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import card_seconds, draw, resolve, tensor
from ahocorasick_tpu_torch.probes.probe import _placement


def timeit2(make_fn, label, lookups_per_rep, reps_lo, reps_hi) -> float:
    """Lookups per second from the best ``reps_hi`` call less the best
    ``reps_lo`` call (3 alternating rounds after a warm-up of each); 0.0
    when noise swamps the difference."""
    f_lo, args = make_fn(reps_lo)
    f_hi, _ = make_fn(reps_hi)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    int(f_lo(*args))
    int(f_hi(*args))
    t_lo, t_hi = _best_pair(lambda: card_seconds(lambda: f_lo(*args), dev),
                            lambda: card_seconds(lambda: f_hi(*args), dev))
    dt = t_hi - t_lo
    if dt <= 0:
        print(f"  {label}: degenerate timing lo={t_lo * 1e3}ms hi={t_hi * 1e3}ms [{dev}]")
        return 0.0
    rate = (reps_hi - reps_lo) * lookups_per_rep / dt
    print(f"  {label}: lo={t_lo * 1e3}ms hi={t_hi * 1e3}ms -> {rate / 1e6} M lookups/s [{dev}]")
    return rate


def make_block_gather(T, B=512, *, rng=None, device=None, placement=None):
    """Chained gather from a T-entry table with ``+ r``, summed."""
    rng, dev = resolve(rng, device)
    p = _placement(placement, T)

    def mk(reps):
        tab = tensor(draw(rng, 0, T, (T // 128, 128), np.int32), dev)
        idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
        return (lambda t, i: kp.chain_gather(t.reshape(-1), i, reps, "add_r", placement=p,
                                             sum_out=True)), (tab, idx)

    return mk


def make_lane_gather(B=512, *, rng=None, device=None, placement=None):
    """The 128-entry chain with ``+ r``, summed."""
    rng, dev = resolve(rng, device)
    p = _placement(placement, 128)

    def mk(reps):
        tab = tensor(draw(rng, 0, 128, (8, 128), np.int32), dev)
        idx = tensor(draw(rng, 0, 128, (B, 128), np.int32), dev)
        return (lambda t, i: kp.chain_gather(t[0], i, reps, "add_r", placement=p,
                                             sum_out=True)), (tab, idx)

    return mk


def make_gather2d(B=512, *, rng=None, device=None):
    """The sublane-then-lane gather on every 8-row tile with ``+ r``, summed
    (the JAX file cannot trace it: its body captures a constant)."""
    rng, dev = resolve(rng, device)
    T = 1024

    def mk(reps):
        tab = tensor(draw(rng, 0, T, (8, 128), np.int32), dev)
        idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
        return (lambda t, i: kp.gather2d(t, i, reps, "gather2d_all", mask=T - 1,
                                         sum_out=True)), (tab, idx)

    return mk


def make_torch_gather(S, A, B=4096, *, rng=None, device=None):
    """Library yardstick: ``s <- (tab[s, c] + r) % S`` as eager indexing."""
    rng, dev = resolve(rng, device)

    def mk(reps):
        tab = tensor(draw(rng, 0, S, (S, A), np.int32), dev)
        s = tensor(draw(rng, 0, S, (B,), np.int32), dev).long()
        c = tensor(draw(rng, 0, A, (B,), np.int32), dev).long()

        def fn(t, s, c):
            for r in range(reps):
                s = (t[s, c].long() + r) % S
            return s.sum()

        return fn, (tab, s, c)

    return mk


def make_torch_row_gather(S, W, B=4096, *, rng=None, device=None):
    """Library yardstick: rows of W words as eager indexing."""
    rng, dev = resolve(rng, device)

    def mk(reps):
        tab = tensor(draw(rng, 0, S, (S, W), np.int32), dev)
        s = tensor(draw(rng, 0, S, (B,), np.int32), dev).long()

        def fn(t, s):
            for r in range(reps):
                rows = t[s].long()
                s = (rows[:, 0] + rows[:, W - 1] + r) % S
            return s.sum()

        return fn, (tab, s)

    return mk


def main(device=None, small: bool = False) -> dict:
    """The JAX file's ``main`` at its sizes (``small``: tiny sizes for the
    CPU twins); returns ``{label: rate}``."""
    rng, dev = resolve(None, device)
    kw = dict(rng=rng, device=dev)
    if small:
        runs = [("lane-gather 128-entry B=8", make_lane_gather(8, **kw), 8 * 128, 2, 6),
                ("2D gather 1024-entry B=16", make_gather2d(16, **kw), 16 * 128, 2, 6),
                ("block-gather T=1024 B=8", make_block_gather(1024, 8, **kw), 8 * 128, 2, 6),
                ("torch elem-gather B=64", make_torch_gather(256, 8, 64, **kw), 64, 2, 6)]
    else:
        runs = [("lane-gather 128-entry B=512", make_lane_gather(**kw), 512 * 128, 2048, 16384),
                ("2D gather 1024-entry B=512", make_gather2d(**kw), 512 * 128, 1024, 8192),
                ("block-gather T=1024 B=512", make_block_gather(1024, **kw), 512 * 128, 1024,
                 8192),
                ("block-gather T=4096 B=512", make_block_gather(4096, **kw), 512 * 128, 512, 4096),
                ("block-gather T=16384 B=256", make_block_gather(16384, B=256, **kw), 256 * 128,
                 128, 1024),
                ("torch elem-gather 8MB B=4096", make_torch_gather(65536, 32, **kw), 4096, 256,
                 2048),
                ("torch elem-gather 256MB B=4096", make_torch_gather(65536, 1024, **kw), 4096,
                 256, 2048),
                ("torch elem-gather 256KB B=4096", make_torch_gather(2048, 32, **kw), 4096, 256,
                 2048),
                ("torch elem-gather 8MB B=64Ki", make_torch_gather(65536, 32, B=65536, **kw),
                 65536, 32, 256),
                ("torch row-gather W=32 8MB", make_torch_row_gather(65536, 32, **kw), 4096, 256,
                 2048)]
    return {label: timeit2(mk, label, per_rep, lo, hi) for label, mk, per_rep, lo, hi in runs}
