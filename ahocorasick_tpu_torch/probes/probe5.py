"""The per-lane column select after a row gather, chained — the port of
``tools/probes/probe5.py``.

The JAX file compared two ways of selecting a column of a gathered row in
vector registers (``onehot``: compare, where, sum; ``logtree``: five rounds
of halving on the bits of c) and swept the lane count B.  ``onehot``
selects ``row[c]``; ``logtree`` halves the row from the top while it reads
the bits of c from the bottom, so it selects ``row[bitrev(c)]``, c's bits
reversed over log2(A) (``_select`` states both in torch; a test holds them
to the JAX bodies).  So on the card both run the ``row_select`` kernel's
select form, which reads the whole row and takes the column from the lane
that loaded it, ``logtree`` on the bit-reversed columns; each line prints
the JAX label with that form.  The B sweep stays: 4,096 to 131,072 chains,
reps ``max(512, 2**22 // B)``.  The JAX file's ``dotbf16`` candidate is in
its docstring only, not in its code.

    python -m ahocorasick_tpu_torch.probes.probe5 [--platform gpu|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.probes import draw, resolve, sum32, tensor
from ahocorasick_tpu_torch.probes.probe3 import timeit2

HOWS = ("onehot", "logtree")
BS = (4096, 32768, 65536, 131072)


def bitrev(c: torch.Tensor, A: int) -> torch.Tensor:
    """``c``'s low log2(A) bits reversed (A a power of two)."""
    bits = A.bit_length() - 1
    out = torch.zeros_like(c)
    for k in range(bits):
        out |= ((c >> k) & 1) << (bits - 1 - k)
    return out


def _select(rows: torch.Tensor, c: torch.Tensor, A: int, how: str) -> torch.Tensor:
    """The JAX ``_select`` on gathered rows ``[B, A]``: ``rows[b, c[b]]``
    (``onehot``) or ``rows[b, bitrev(c[b])]`` (``logtree``, A a power of
    two)."""
    if how == "onehot":
        oh = torch.arange(A, device=rows.device)[None, :] == c[:, None]
        return torch.where(oh, rows, torch.zeros_like(rows)).sum(dim=1, dtype=rows.dtype)
    if how == "logtree":
        cur = rows
        for k in range(A.bit_length() - 1):
            half = cur.shape[1] // 2
            take_hi = ((c >> k) & 1).bool()[:, None]
            cur = torch.where(take_hi, cur[:, half:], cur[:, :half])
        return cur[:, 0]
    raise ValueError(how)


def make_row_step(S, A, B, how, *, rng=None, device=None):
    """``mk(reps) -> (fn, args)``: ``reps`` chained steps ``s <- (row[c_r] +
    r) % S`` of B lanes on the kernel (``row[bitrev(c_r)]`` for
    ``logtree``), the int32 sum of the final states; the JAX ``mk``'s draws
    (table, 8 column rows, start states)."""
    if how not in HOWS:
        raise ValueError(how)
    rng, dev = resolve(rng, device)

    def mk(reps):
        tab = tensor(draw(rng, 0, S, (S, A), np.int32), dev)
        cs = tensor(draw(rng, 0, A, (8, B), np.int32), dev)

        def fn(t, s, cs):
            cols = cs if how == "onehot" else bitrev(cs, A)
            return sum32(kp.row_select(t, s, cols, reps, "select", S, add_r=True))

        s = tensor(draw(rng, 0, S, (B,), np.int32), dev)
        return fn, (tab, s, cs)

    return mk


def main(device=None, small: bool = False, *, rng=None) -> dict:
    """The JAX file's sweep (``small``: S, B and reps cut for the CPU
    twins); returns ``{label: rows per second}``."""
    rng, dev = resolve(rng, device)
    print(f"devices: [{dev}]")
    out = {}
    for how in HOWS:
        for B in BS:
            lab = f"row-step {how} S=64k A=32 B={B} [row_select select]"
            S, b, lo, hi = (65536, B, 64, max(512, (1 << 22) // B)) if not small else (
                256, B // 1024, 2, 6)
            out[lab] = timeit2(make_row_step(S, 32, b, how, rng=rng, device=dev), lab, b, lo, hi)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe5")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    a = ap.parse_args()
    main("cpu" if a.platform == "cpu" else None, small=a.platform == "cpu")
