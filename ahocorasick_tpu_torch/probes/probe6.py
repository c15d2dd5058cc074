"""Data-dependent gathers inside a kernel — the port of the Pallas section
of ``tools/probes/probe6.py`` (``probe_pallas_gathers``; the JAX file's
``*_width`` probes are XLA-only and its ``main`` does not run them).

Four formulations on a uint32 table of ``S * A`` entries (flat, and as
``(S, A)`` rows), 8 x 128 chains of ``T`` steps: the flat element gather and
``jnp.take`` (both ``s <- tab[s] % S``: ``chain_gather``'s load_mod op), the
row gather ``s <- tab[s, 0] % S`` (``row_chain``) and the sublane gather
``s <- (tab[s % 8, j] + s) % 8`` on ``tab[0:8, 0:128]`` (``gather2d``), which
is defined only where the table has 128 columns or more: for fewer it raises
``ValueError``, as the JAX trace fails on the shapes.
"""

from __future__ import annotations

import numpy as np

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import resolve, tensor
from ahocorasick_tpu_torch.probes.probe import _timeit


def probe_pallas_gathers(S=51200, A=32, T=64, *, rng=None, device=None) -> dict:
    """``{name: (rate, out)}``, or ``{name: ValueError}`` for a formulation
    the table's shape does not define (printed as FAIL, as the JAX
    ``try_one`` prints it).  ``rng`` defaults to ``default_rng(0)``, the JAX
    probe's."""
    rng, dev = resolve(np.random.default_rng(0) if rng is None else rng, device)
    print("== in-kernel gather formulations ==")
    flat_np = rng.integers(0, S * A, size=(S * A,), dtype=np.int64).astype(np.uint32)
    flat = tensor(flat_np, dev)
    tab2 = flat.reshape(S, A)
    idx0 = tensor(rng.integers(0, S, size=(8, 128)).astype(np.int32), dev)
    p = kp.default_placement(S * A)

    def sublane(t, s):
        if t.shape[1] < 128:
            raise ValueError(f"the sublane gather reads tab[0:8, 0:128]; the table has "
                             f"{t.shape[1]} columns")
        return kp.gather2d(t[0:8, 0:128].contiguous(), s, T, "sublane_chain")

    forms = [
        ("flat element gather tab[s] (vec)",
         lambda t, s: kp.chain_gather(t, s, T, "load_mod", mod=S, placement=p), flat, p),
        ("jnp.take flat (vec)",
         lambda t, s: kp.chain_gather(t, s, T, "load_mod", mod=S, placement=p), flat, p),
        ("row gather tab[s, :] (vec)", lambda t, s: kp.row_chain(t, s, T, "col0", S), tab2,
         "global, a warp per row"),
        ("sublane take_along_axis (8,128)", sublane, tab2, "shared"),
    ]
    out = {}
    for name, fn, tab, where in forms:
        try:
            out[name] = _timeit(fn, tab, idx0, label=f"{name:34s} OK",
                                lookups_per_call=8 * 128 * T, placement=where)
        except ValueError as e:
            print(f"  {name:34s} FAIL {e}")
            out[name] = e
    return out


def main(device=None, small: bool = False) -> dict:
    """``probe_pallas_gathers`` at the JAX file's sizes (``small``: a
    512 x 32 table and 8 steps, for the CPU twins)."""
    return probe_pallas_gathers(**(dict(S=512, T=8) if small else {}), device=device)
