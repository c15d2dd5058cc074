"""The row-gather DFA step, chained — the port of ``tools/probes/probe4.py``.

Each step reads a whole row ``table[s]`` and selects the lane's column
``c``, the next step's row depending on the value: ``s <- (select(table[s],
c_r) + r) % S``, on the ``row_select`` kernel (``kernels/probes.py``,
``csrc/probes.cu``).  The JAX file's three consumers map onto its two forms:
``onehot`` and ``take`` are both ``row[c]`` after the whole-row read
(``how="select"``), and the full-row ``sum`` control is ``how="sum"``; each
line prints the JAX label with the form it ran, as ``probe6`` labels its
flat and ``jnp.take`` gathers.  Timing is ``probe3.timeit2``, the paired
difference of two rep counts.  The JAX file's ``devices`` line becomes the
device the probe ran on.

    python -m ahocorasick_tpu_torch.probes.probe4 [--platform gpu|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import draw, resolve, sum32, tensor
from ahocorasick_tpu_torch.probes.probe3 import timeit2

SELS = {"onehot": "select", "take": "select", "sum": "sum"}  # JAX consumer -> row_select form


def make_row_step(S, A, B=4096, sel="onehot", *, rng=None, device=None):
    """``mk(reps) -> (fn, args)``: ``fn(*args)`` runs ``reps`` chained row
    steps of B lanes over a fresh (S, A) int32 table and returns the int32
    sum of the final states, as the JAX ``fn`` does.  The draws are the JAX
    ``mk``'s: the table, the 8 column rows, the start states."""
    rng, dev = resolve(rng, device)
    how = SELS[sel]

    def mk(reps):
        tab = tensor(draw(rng, 0, S, (S, A), np.int32), dev)
        cs = tensor(draw(rng, 0, A, (8, B), np.int32), dev)

        def fn(t, s, cs):
            return sum32(kp.row_select(t, s, cs, reps, how, S, add_r=True))

        s = tensor(draw(rng, 0, S, (B,), np.int32), dev)
        return fn, (tab, s, cs)

    return mk


def label(text: str, sel: str) -> str:
    """The JAX label with the form that ran it."""
    return f"{text} [row_select {SELS[sel]}]"


CELLS = (  # (S, A, sel, B, JAX label, reps lo, reps hi): probe4.py:50-71
    (65536, 32, "onehot", 4096, "row-step onehot S=64k A=32 B=4096 (8MB)", 64, 512),
    (65536, 32, "take", 4096, "row-step take S=64k A=32 B=4096 (8MB)", 64, 512),
    (65536, 32, "sum", 4096, "row-step sum-control S=64k A=32 (8MB)", 64, 512),
    (1 << 21, 32, "onehot", 4096, "row-step onehot S=2M A=32 B=4096 (268MB)", 64, 512),
    (65536, 1024, "onehot", 2048, "row-step onehot S=64k A=1024 B=2048 (256MB)", 32, 256),
    (65536, 32, "onehot", 32768, "row-step onehot S=64k A=32 B=32k", 16, 128),
    (1024, 32, "onehot", 4096, "row-step onehot S=1024 A=32 B=4096 (128KB)", 64, 512),
)


def main(device=None, small: bool = False, *, rng=None) -> dict:
    """The JAX file's seven cells (``small``: S, A and B cut for the CPU
    twins, the reps too); returns ``{label: rows per second}``."""
    rng, dev = resolve(rng, device)
    print(f"devices: [{dev}]")
    out = {}
    for S, A, sel, B, text, lo, hi in CELLS:
        if small:
            S, A, B, lo, hi = min(S, 256), min(A, 32), min(B, 64), 2, 6
        lab = label(text, sel)
        out[lab] = timeit2(make_row_step(S, A, sel=sel, B=B, rng=rng, device=dev), lab, B, lo,
                           hi)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe4")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    a = ap.parse_args()
    main("cpu" if a.platform == "cpu" else None, small=a.platform == "cpu")
