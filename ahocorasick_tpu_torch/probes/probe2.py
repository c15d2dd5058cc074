"""Sustained block-gather rates and the sublane gathers — the port of
``tools/probes/probe2.py``.

``probe_block_gather_sustained`` is ``chain_gather``'s add op with the step
number added; ``probe_sublane_gather`` and ``probe_gather2d`` run
``gather2d`` (the one-shot sublane gather, and the sublane-then-lane gather
on the first 8-row tile, which the JAX file cannot trace: its body captures
a constant).  The XLA element and row gathers of the JAX file are here the
library yardstick, eager torch indexing, which the port never uses.
"""

from __future__ import annotations

import numpy as np

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import draw, resolve, tensor
from ahocorasick_tpu_torch.probes.probe import _placement, _timeit


def probe_block_gather_sustained(T, reps, B=512, *, rng=None, device=None, placement=None):
    """Chained gather from a T-entry table, ``+ r`` per step."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, T, (T // 128, 128), np.int32), dev)
    idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
    p = _placement(placement, T)
    return _timeit(lambda t, i: kp.chain_gather(t.reshape(-1), i, reps, "add_r", placement=p),
                   tab, idx, label=f"block-gather T={T} reps={reps} B={B}",
                   lookups_per_call=reps * B * 128, placement=p)


def probe_sublane_gather(*, rng=None, device=None):
    """``out[i, j] = tab[idx[i, j] & 7, j]`` once on (8, 128)."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, 100, (8, 128), np.int32), dev)
    idx = tensor(draw(rng, 0, 8, (8, 128), np.int32), dev)
    return _timeit(lambda t, i: kp.gather2d(t, i, 1, "sublane"), tab, idx,
                   label="sublane gather (axis=0)", lookups_per_call=1024,
                   placement="shared")


def probe_gather2d(T=1024, reps=1024, B=512, *, rng=None, device=None):
    """A 1024-entry table as (8, 128): sublane gather then lane gather on
    rows 0-7, every row masked to T - 1 per step."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, T, (8, 128), np.int32), dev)
    idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
    return _timeit(lambda t, i: kp.gather2d(t, i, reps, "gather2d_first", mask=T - 1), tab, idx,
                   label="2D gather (sublane+lane) T=1024", lookups_per_call=reps * 8 * 128,
                   placement="shared")


def probe_torch_elem_gather(S, A, reps, B=4096, *, rng=None, device=None):
    """Library yardstick: ``s <- (tab[s, c] + r) % S`` as eager indexing."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, S, (S, A), np.int32), dev)
    s = tensor(draw(rng, 0, S, (B,), np.int32), dev).long()
    c = tensor(draw(rng, 0, A, (B,), np.int32), dev).long()

    def fn(t, s, c):
        for r in range(reps):
            s = (t[s, c].long() + r) % S
        return s

    return _timeit(fn, tab, s, c, label=f"torch elem-gather S={S} A={A} "
                   f"({S * A * 4 // (1 << 20)}MB) B={B}", lookups_per_call=reps * B,
                   placement="library: eager torch indexing")


def probe_torch_row_gather(S, W, reps, B=4096, *, rng=None, device=None):
    """Library yardstick: rows of W words, ``s <- (row[0] + row[W-1] + r) %
    S`` as eager indexing."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, S, (S, W), np.int32), dev)
    s = tensor(draw(rng, 0, S, (B,), np.int32), dev).long()

    def fn(t, s):
        for r in range(reps):
            rows = t[s].long()
            s = (rows[:, 0] + rows[:, W - 1] + r) % S
        return s

    return _timeit(fn, tab, s, label=f"torch row-gather S={S} W={W} "
                   f"({S * W * 4 // (1 << 20)}MB)", lookups_per_call=reps * B,
                   placement="library: eager torch indexing")


def main(device=None, small: bool = False) -> dict:
    """The JAX file's ``main`` at its sizes, with ``probe_gather2d`` (which
    the JAX ``main`` leaves out); ``small``: tiny sizes for the CPU twins."""
    rng, dev = resolve(None, device)
    kw = dict(rng=rng, device=dev)
    if small:
        runs = [("sublane", probe_sublane_gather, {}),
                ("sustained T=4096", probe_block_gather_sustained, dict(T=256, reps=4, B=8)),
                ("sustained T=32768", probe_block_gather_sustained, dict(T=1024, reps=4, B=8)),
                ("gather2d", probe_gather2d, dict(reps=4, B=16)),
                ("torch elem", probe_torch_elem_gather, dict(S=256, A=8, reps=4, B=64)),
                ("torch row", probe_torch_row_gather, dict(S=256, W=8, reps=4, B=64))]
    else:
        runs = [("sublane", probe_sublane_gather, {}),
                ("sustained T=4096", probe_block_gather_sustained, dict(T=4096, reps=4096)),
                ("sustained T=32768", probe_block_gather_sustained, dict(T=32768, reps=512)),
                ("sustained T=131072", probe_block_gather_sustained, dict(T=131072, reps=128)),
                ("gather2d", probe_gather2d, {}),
                ("torch elem 8MB", probe_torch_elem_gather, dict(S=65536, A=32, reps=256)),
                ("torch elem 256MB", probe_torch_elem_gather, dict(S=65536, A=1024, reps=256)),
                ("torch row W=32", probe_torch_row_gather, dict(S=65536, W=32, reps=256)),
                ("torch row W=256", probe_torch_row_gather, dict(S=65536, W=256, reps=128)),
                ("torch row big batch", probe_torch_row_gather,
                 dict(S=2048, W=32, reps=256, B=65536))]
    return {label: fn(**args, **kw) for label, fn, args in runs}
