"""Data-dependent gathers inside a kernel, and the row read against its
width — the port of ``tools/probes/probe6.py``.

``main`` runs the Pallas section (``probe_pallas_gathers``), as the JAX
``main`` does.  The two row-width probes (``probe_xla_row_gather_width``,
``probe_hbm_row_gather_width``: a dependent chain of whole-row reads and a
one-hot column select, from a table in cache and from device memory) run
the ``row_select`` kernel's select form and are run by ``python -m
ahocorasick_tpu_torch.probes --widths``; each is timed best of 3 by CUDA
events on the card alone.  The JAX file warned that their timings were unreliable through its
TPU link; the card is attached directly, so that warning does not carry
over.

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
import torch

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import card_seconds, resolve, tensor
from ahocorasick_tpu_torch.probes.probe import _timeit

WIDTHS_XLA = (8, 16, 32, 64, 128, 256)  # probe6.py:48
WIDTHS_HBM = (32, 128, 512, 1024)  # probe6.py:77


def _width_chain(S, B, T, A, rng, dev):
    """``(seconds, sum)`` of the JAX ``run``: B chains from state 0 over T
    steps ``s <- row[cols[t]] % S`` of a fresh uint32 (S, A) table, best of
    3 card times (``card_seconds``) after a warm-up; ``sum`` the final
    states' sum.  The draws are the JAX probe's, from ``default_rng(0)`` for
    each width (``rng``, where given, draws every width in turn)."""
    g = np.random.default_rng(0) if rng is None else rng
    tab = tensor(g.integers(0, S, size=(S, A), dtype=np.int64).astype(np.uint32), dev)
    cols = tensor(g.integers(0, A, size=(T, B)).astype(np.int32), dev)
    s0 = torch.zeros(B, dtype=torch.int32, device=dev).view(torch.uint32)

    def run():
        return kp.row_select(tab, s0, cols, T, "select", S)

    total = int((run().to(torch.int64) & 0xFFFFFFFF).sum())
    return min(card_seconds(run, dev) for _ in range(3)), total


def probe_xla_row_gather_width(S=51200, B=65536, T=64, *, rng=None, device=None) -> dict:
    """Dependent-chain row read + column select, against row width:
    ``{A: (rows per second, sum)}``."""
    dev = resolve(None, device)[1]
    print("== row read rate vs row width, table in cache (dependent chain) ==")
    out = {}
    for A in WIDTHS_XLA:
        dt, total = _width_chain(S, B, T, A, rng, dev)
        rate = B * T / dt / 1e6
        print(f"  A={A:4d}  ({S * A * 4 / 2**20:7.1f} MB)  {rate:8.1f} M rows/s  "
              f"{1e9 * dt / (B * T):6.2f} ns/row [row_select select, {dev}]")
        out[A] = (rate * 1e6, total)
    return out


def probe_hbm_row_gather_width(S=470_000, B=65536, T=16, *, rng=None, device=None) -> dict:
    """The same chain from a table past the L2 (does width amortize?):
    ``{A: (rows per second, sum)}``; tables over 4 GiB are skipped, as in
    the JAX probe."""
    dev = resolve(None, device)[1]
    print("== row read rate vs row width, table in device memory (dependent chain) ==")
    out = {}
    for A in WIDTHS_HBM:
        nbytes = S * A * 4
        if nbytes > 4 << 30:
            continue
        dt, total = _width_chain(S, B, T, A, rng, dev)
        rate = B * T / dt / 1e6
        print(f"  A={A:5d} ({nbytes / 2**20:7.0f} MB)  {rate:8.1f} M rows/s  "
              f"{rate * A * 4 / 1e3:7.1f} GB/s effective [row_select select, {dev}]")
        out[A] = (rate * 1e6, total)
    return out


def widths(device=None, small: bool = False) -> dict:
    """Both width probes at the JAX sizes (``small``: S, B and T cut for the
    CPU twins)."""
    if small:
        return {"xla": probe_xla_row_gather_width(S=64, B=32, T=4, device=device),
                "hbm": probe_hbm_row_gather_width(S=64, B=32, T=4, device=device)}
    return {"xla": probe_xla_row_gather_width(device=device),
            "hbm": probe_hbm_row_gather_width(device=device)}


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
