"""The chunk stitch's fold (``entry_fold``, B15) on the CPU: the plain twin
that the wrapper runs for CPU tensors and the twin in the kernel's lanes
(``spec_fold_plain``: entries and each lane's re-folded length) against the
JAX package's ``entry_states``.

On the card the fold is speculate and repair in one block: lane p of L
lanes folds ``per`` chunks from the guess ``sigma[p per - 1][s0]``, then the
lanes whose guess was wrong are re-folded in lane order from the exit of the
lane before, each up to the first chunk whose recorded entry it meets.  The
maps here: constant (every guess right, no repair), identity, uniform random
(every guess wrong, almost no meeting), a mix of constant, identity, random
and permutation maps, and swaps (the guess alternates right and wrong and no
re-fold ever meets, so each changes its lane's exit).  C runs over 1, 2, 31,
32, 33, P - 1, P, P + 1, 4,096 and 4,097 for P = ``FOLD_LANES`` (1,024) and
for P patched to 32 and 1; s0 is 0 and S - 1.  Then the fold of
``chunk_state_maps`` from both packages on the demo dictionary and a goto
closure.  Everything compared is an integer: exact equality.
"""

import numpy as np
import pytest
import torch

from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import stitch as jax_stitch
from ahocorasick_tpu_torch.graft_entry import _KEYWORDS as DEMO
from ahocorasick_tpu_torch.kernels import stitch as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import stitch as port_stitch
from test_torch_stitch_sync import _classes, _table

S = 37
KINDS = ("constant", "identity", "random", "mixed", "swaps")


def _edges(P: int):
    return sorted({c for c in (1, 2, 31, 32, 33, P - 1, P, P + 1, 4096, 4097) if c >= 1})


def _maps(kind: str, C: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.repeat(rng.integers(0, S, (C, 1)), S, axis=1).astype(np.int32)
    if kind == "identity":
        return np.tile(np.arange(S, dtype=np.int32), (C, 1))
    if kind == "random":
        return rng.integers(0, S, (C, S)).astype(np.int32)
    if kind == "swaps":  # states 0 and S - 1 swapped by every map
        out = np.tile(np.arange(S, dtype=np.int32), (C, 1))
        out[:, [0, S - 1]] = [S - 1, 0]
        return out
    pick = rng.integers(0, 4, C)
    out = rng.integers(0, S, (C, S)).astype(np.int32)
    out[pick == 0] = rng.integers(0, S, (int((pick == 0).sum()), 1))
    out[pick == 1] = np.arange(S)
    for c in np.flatnonzero(pick == 2):
        out[c] = rng.permutation(S)
    return out


def _jax_entries(sigma: np.ndarray, s0: int) -> np.ndarray:
    return np.asarray(jax_stitch.entry_states(sigma, s0))


def _check(sigma: np.ndarray, s0: int):
    """Both twins against JAX; returns the lanes' repair lengths."""
    want = _jax_entries(sigma, s0)
    t = torch.from_numpy(sigma)
    before = launches["entry_fold"]
    np.testing.assert_array_equal(kernels.entry_fold(t, s0).numpy(), want)
    np.testing.assert_array_equal(port_stitch.entry_states(t, s0).numpy(), want)
    entry, repair = kernels.spec_fold(t, s0)
    np.testing.assert_array_equal(entry.numpy(), want)
    per, lanes = kernels.fold_shape(sigma.shape[0])
    assert repair.dtype == torch.int32 and repair.shape == (lanes,)
    assert int(repair[0]) == 0 and int(repair.max()) <= per
    assert launches["entry_fold"] == before  # CPU tensors launch nothing
    return repair.numpy()


@pytest.mark.parametrize("s0", [0, S - 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("C", _edges(kernels.FOLD_LANES))
def test_fold_against_jax(C, kind, s0):
    repair = _check(_maps(kind, C, seed=C), s0)
    if kind in ("constant", "identity"):
        assert not repair.any()  # every guess is right


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_in_fewer_lanes(monkeypatch, lanes, kind):
    monkeypatch.setattr(kernels, "FOLD_LANES", lanes)
    for C in _edges(lanes):
        for s0 in (0, S - 1):
            repair = _check(_maps(kind, C, seed=C + lanes), s0)
            if lanes == 1 or kind in ("constant", "identity"):
                assert not repair.any()


def test_swaps_repair_every_wrong_lane_to_its_end(monkeypatch):
    """Swaps never meet: a lane whose guess is wrong re-folds its whole run
    and hands the next lane a new exit, so the verdicts alternate with the
    parity of the chunks before a lane."""
    monkeypatch.setattr(kernels, "FOLD_LANES", 8)
    C = 8 * 5 - 2  # per = 5, the last lane 3 chunks
    sigma = _maps("swaps", C, 0)
    _, repair = kernels.spec_fold_plain(torch.from_numpy(sigma), 0)
    per, lanes = kernels.fold_shape(C)
    # lane p's true entry is s0 swapped p * per times; its guess is s0 swapped once
    want = [0] + [min(per, C - p * per) if (p * per) % 2 == 0 else 0 for p in range(1, lanes)]
    assert repair.tolist() == want


def test_fold_shape(monkeypatch):
    assert kernels.fold_shape(0) == (0, 0)
    assert kernels.fold_shape(1) == (1, 1)
    assert kernels.fold_shape(1024) == (1, 1024)
    assert kernels.fold_shape(1025) == (2, 513)
    assert kernels.fold_shape(4096) == (4, 1024)
    assert kernels.fold_shape(4097) == (5, 820)
    for C in range(1, 3000, 7):
        per, lanes = kernels.fold_shape(C)
        assert lanes <= kernels.FOLD_LANES and (lanes - 1) * per < C <= lanes * per
    monkeypatch.setattr(kernels, "FOLD_LANES", 32)
    assert kernels.fold_shape(33) == (2, 17)


def test_fold_refuses_an_entry_state_outside_the_table():
    sigma = torch.zeros((3, S), dtype=torch.int32)
    for bad in (-1, S):
        with pytest.raises(ValueError, match="outside"):
            kernels.spec_fold(sigma, bad)
    assert kernels.spec_fold(torch.zeros((0, S), dtype=torch.int32))[0].shape == (0,)


def _demo_case():
    m = jax_compile(DEMO, "ac", True)
    rng = np.random.default_rng(4)
    words = rng.choice(DEMO, size=3000)
    text = " ".join(w if rng.random() < 0.5 else w[::-1] for w in words)
    units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
    return m.dfa_next.astype(np.int32), m.charmap[units].astype(np.int32), max(m.max_depth, 1)


@pytest.mark.parametrize("lanes", [1024, 32, 3])
@pytest.mark.parametrize("case", ["demo", "goto fuzz", "goto deep"])
def test_fold_of_the_packages_maps(monkeypatch, case, lanes):
    """sigma from the JAX ``chunk_state_maps`` and from the port's
    ``chunk_state_maps`` (both forms) agree, and the fold of each equals the
    JAX ``entry_states``; then the stitched scan equals the JAX one."""
    monkeypatch.setattr(kernels, "FOLD_LANES", lanes)
    if case == "demo":
        table, cls, d = _demo_case()
        C = 97
        cls = cls[: C * (len(cls) // C)].reshape(C, -1)
    else:
        form = case.split()[1]
        table, d, _ = _table(form)
        cls = _classes(form, 97, 23, seed=29)
    want_sigma = np.asarray(jax_stitch.chunk_state_maps(table, cls))
    t, c = torch.from_numpy(table), torch.from_numpy(np.ascontiguousarray(cls))
    for depth in (None, d):
        sigma = port_stitch.chunk_state_maps(t, c, depth)
        np.testing.assert_array_equal(sigma.numpy(), want_sigma)
        for s0 in (0, int(table.shape[0]) - 1):
            want = _jax_entries(want_sigma, s0)
            entry, repair = kernels.spec_fold(sigma, s0)
            np.testing.assert_array_equal(entry.numpy(), want)
            np.testing.assert_array_equal(kernels.entry_fold(sigma, s0).numpy(), want)
            np.testing.assert_array_equal(
                port_stitch.stitched_scan(t, c, s0, depth).numpy(),
                np.asarray(jax_stitch.stitched_states(table, cls, want)))
            if case != "demo" or lanes == 1024:
                continue
            # chunks of the demo dictionary's text are longer than its depth:
            # every map is constant, so every guess is right
            assert not repair.numpy().any()
