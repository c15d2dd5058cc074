"""Chained lookup probes — the port of ``tools/probes/probe.py``.

Each probe chains ``reps`` dependent lookups per lane inside one kernel, so
nothing can be hoisted, and reports lookups per second.  P1 / P1b / P6 are
``chain_gather``'s add op (the Pallas lane gather, block gather and flat
gather all compute ``idx <- (idx + tab[idx]) & (T-1)``), P2 its load op, P3
``row_chain``, P4 ``onehot_mma`` on the tensor cores.  P5, XLA's gather in
the JAX file, is here the library yardstick: the same chain as eager torch
indexing (``probe_torch_gather``), which the port never uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ahocorasick_tpu_torch.bench import _elapsed
from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import draw, resolve, tensor


def _timeit(fn, *args, label="", lookups_per_call=0, placement=""):
    """``(lookups per second, out)``: best of 3 timed calls after a warm-up
    call (which also builds the kernel library)."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    out = fn(*args)
    best = min(_elapsed(lambda: fn(*args), 1, dev) for _ in range(3))
    rate = lookups_per_call / best
    where = f"{placement}, " if placement else ""
    print(f"  {label}: {best * 1e3} ms -> {rate / 1e6} M lookups/s [{where}{dev}]")
    return rate, out


def _placement(placement, T):
    return kp.default_placement(T) if placement is None else placement


def probe_lane_gather(reps=2048, B=512, *, rng=None, device=None, placement=None):
    """P1: 128-entry table (row 0 of an (8, 128) draw), B x 128 chains."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, 128, (8, 128), np.int32), dev)
    idx = tensor(draw(rng, 0, 128, (B, 128), np.int32), dev)
    p = _placement(placement, 128)
    return _timeit(lambda t, i: kp.chain_gather(t[0], i, reps, "add", placement=p), tab, idx,
                   label=f"P1 lane-gather 128-entry chained (B={B})",
                   lookups_per_call=reps * B * 128, placement=p)


def probe_block_gather(T=4096, reps=256, B=256, *, rng=None, device=None, placement=None):
    """P1b: T entries drawn as (T // 128, 128), the same chain."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, T, (T // 128, 128), np.int32), dev)
    idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
    p = _placement(placement, T)
    return _timeit(lambda t, i: kp.chain_gather(t.reshape(-1), i, reps, "add", placement=p),
                   tab, idx, label=f"P1b block-gather T={T} (B={B})",
                   lookups_per_call=reps * B * 128, placement=p)


def probe_scalar_chain(S=4096, reps=4096, K=8, *, rng=None, device=None, placement=None):
    """P2: K chains s <- tab[s] over an S-entry table."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, S, (S // 128, 128), np.int32), dev)
    s0 = tensor(draw(rng, 0, S, (K,), np.int32), dev)
    p = _placement(placement, S)
    return _timeit(lambda t, s: kp.chain_gather(t.reshape(-1), s, reps, "load", placement=p),
                   tab, s0, label=f"P2 scalar chain K={K} S={S}", lookups_per_call=reps * K,
                   placement=p)


def probe_row_slice(S=4096, reps=2048, K=4, *, rng=None, device=None):
    """P3: K chains s <- max(tab[s, :]) % S over an (S, 128) table."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, S, (S, 128), np.int32), dev)
    s0 = tensor(draw(rng, 0, S, (K,), np.int32), dev)
    return _timeit(lambda t, s: kp.row_chain(t, s, reps, "max", S), tab, s0,
                   label=f"P3 row-slice chain K={K}", lookups_per_call=reps * K,
                   placement="global, a warp per row")


def probe_mxu_onehot(T=2048, reps=128, B=1024, *, rng=None, device=None):
    """P4: one-hot (B, T) @ (T, 128) per step on the tensor cores."""
    rng, dev = resolve(rng, device)
    tab = kp.onehot_table(tensor(draw(rng, 0, T, (T, 128)).astype(np.float32), dev))
    idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
    return _timeit(lambda t, i: kp.onehot_mma(t, i, reps), tab, idx,
                   label=f"P4 tensor-core one-hot T={T} (B={B}/step)",
                   lookups_per_call=reps * B, placement="shared, mma.sync")


def probe_torch_gather(S=65536, A=32, reps=64, B=4096, *, rng=None, device=None):
    """P5's counterpart, the library yardstick: ``s <- tab[s, c] % S`` as
    eager torch indexing, one gather launch per step."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, S, (S, A), np.int32), dev)
    s = tensor(draw(rng, 0, S, (B,), np.int32), dev).long()
    c = tensor(draw(rng, 0, A, (B,), np.int32), dev).long()

    def fn(t, s, c):
        for _ in range(reps):
            s = t[s, c].long() % S
        return s

    return _timeit(fn, tab, s, c, label=f"P5 torch gather S={S} A={A} B={B}",
                   lookups_per_call=reps * B, placement="library: eager torch indexing")


def probe_flat_gather(T=1 << 20, reps=64, B=512, *, rng=None, device=None, placement=None):
    """P6: a flat T-entry table, the add chain."""
    rng, dev = resolve(rng, device)
    tab = tensor(draw(rng, 0, T, (T,), np.int32), dev)
    idx = tensor(draw(rng, 0, T, (B, 128), np.int32), dev)
    p = _placement(placement, T)
    return _timeit(lambda t, i: kp.chain_gather(t, i, reps, "add", placement=p), tab, idx,
                   label=f"P6 flat gather T={T}", lookups_per_call=reps * B * 128, placement=p)


def main(device=None, small: bool = False) -> dict:
    """The JAX file's ``main`` at its sizes (``small``: tiny sizes for the
    CPU twins); returns ``{label: (rate, out)}``."""
    rng, dev = resolve(None, device)
    kw = dict(rng=rng, device=dev)
    if small:
        runs = [("P1", probe_lane_gather, dict(reps=4, B=8)),
                ("P1b T=4096", probe_block_gather, dict(T=256, reps=4, B=8)),
                ("P1b T=32768", probe_block_gather, dict(T=1024, reps=4, B=8)),
                ("P2 S=4096", probe_scalar_chain, dict(S=256, reps=8, K=8)),
                ("P2 S=262144", probe_scalar_chain, dict(S=1024, reps=8, K=16)),
                ("P3", probe_row_slice, dict(S=256, reps=4, K=4)),
                ("P4", probe_mxu_onehot, dict(T=64, reps=2, B=16)),
                ("P5", probe_torch_gather, dict(S=256, A=8, reps=4, B=64)),
                ("P6", probe_flat_gather, dict(T=1024, reps=4, B=8))]
    else:
        runs = [("P1", probe_lane_gather, {}),
                ("P1b T=4096", probe_block_gather, dict(T=4096)),
                ("P1b T=32768", probe_block_gather, dict(T=32768, reps=64, B=128)),
                ("P2 S=4096", probe_scalar_chain, {}),
                ("P2 S=262144", probe_scalar_chain, dict(S=65536 * 4, reps=4096, K=16)),
                ("P3", probe_row_slice, {}),
                ("P4", probe_mxu_onehot, {}),
                ("P5", probe_torch_gather, {}),
                ("P6", probe_flat_gather, {})]
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    return {label: fn(**args, **kw) for label, fn, args in runs}
