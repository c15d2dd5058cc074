"""The chained row step (``row_select``) on the CPU: the port's ``probe4``,
``probe5`` and ``probe6``'s two row-width probes (the kernel's plain twin)
against the JAX probes of ``tools/probes/`` on the same seeded inputs, and
the twin against a numpy model of the kernel's lanes.

What each test compares:

* probe4 / probe5: the JAX ``make_row_step(...)(reps)`` gives ``(fn,
  args)``; ``fn(*args)``, the int32 sum of the final states, against the
  port's ``fn(*args)`` from the same ``np.random`` seed, for every consumer
  (``onehot``, ``take`` and the ``sum`` control; ``onehot`` and ``logtree``,
  which selects the bit-reversed column);
  the JAX ``fn`` also on a table of full-range int32 words, whose row sums
  wrap and go negative (floor modulo), against the port's on the same table;
  probe5's ``_select`` against the JAX one on the same rows;
* probe6: the JAX width probes with ``_timeit`` patched to record
  ``fn(*args)`` (the final states' sum) against the port's sums, at every
  width of their lists;
* the twin against a numpy model of the kernel: lane g of a group of G reads
  words g, g + G, ... (16-byte words where A % 4 == 0) in batches of kB,
  keeps the chosen column's word, and the group takes it from lane
  ``word % G`` (the select), or adds every lane's words (the sum), at A = 1,
  27, 28 and 1,024, every group size;
* the wrappers' refusals.

Every value is an integer: exact equality.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools", "probes"))
import probe4 as jprobe4  # noqa: E402
import probe5 as jprobe5  # noqa: E402
import probe6 as jprobe6  # noqa: E402

from ahocorasick_tpu_torch.kernels import probes as kp  # noqa: E402
from ahocorasick_tpu_torch.kernels.build import launches  # noqa: E402
from ahocorasick_tpu_torch.probes import probe4, probe5, probe6  # noqa: E402


def _jax(make, seed, reps, *margs):
    np.random.seed(seed)
    fn, args = make(*margs)(reps)
    return fn, args, int(fn(*args))


def _port(make, seed, reps, *margs):
    fn, args = make(*margs, rng=np.random.RandomState(seed), device="cpu")(reps)
    before = launches["row_select"]
    got = int(fn(*args))
    assert launches["row_select"] == before  # CPU tensors launch nothing
    return fn, args, got


@pytest.mark.parametrize("shape", [(64, 32, 16, 7), (40, 27, 33, 5)], ids=["64x32", "40x27"])
@pytest.mark.parametrize("sel", ["onehot", "take", "sum"])
def test_probe4_row_step_matches_jax(sel, shape):
    S, A, B, reps = shape
    seed = 11 + A
    want = _jax(lambda S, A, B: jprobe4.make_row_step(S, A, B, sel), seed, reps, S, A, B)[2]
    got = _port(lambda S, A, B, **kw: probe4.make_row_step(S, A, B, sel, **kw), seed, reps, S,
                A, B)[2]
    assert got == want


@pytest.mark.parametrize("sel", ["sum", "onehot"])
def test_probe4_full_range_words_wrap_as_jax(sel):
    """A table of full-range int32 words: the row sums wrap and go negative,
    the step's modulo is floor modulo, the select's values are negative."""
    S, A, B, reps = 64, 32, 16, 6
    jfn, jargs, _ = _jax(lambda: jprobe4.make_row_step(S, A, B, sel), 3, reps)
    pfn, pargs, _ = _port(lambda **kw: probe4.make_row_step(S, A, B, sel, **kw), 3, reps)
    rng = np.random.default_rng(4)
    tab = rng.integers(-(1 << 31), 1 << 31, (S, A), dtype=np.int64).astype(np.int32)
    tab[0] = np.int32((1 << 31) - 1)  # every sum of row 0 wraps
    assert int(tab.astype(np.int64).sum(axis=1).max()) >= 1 << 31
    want = int(jfn(jnp.asarray(tab), *jargs[1:]))
    got = int(pfn(torch.from_numpy(tab), *pargs[1:]))
    assert got == want


@pytest.mark.parametrize("shape", [(64, 32, 24, 9), (50, 8, 17, 4)], ids=["A32", "A8"])
@pytest.mark.parametrize("how", probe5.HOWS)
def test_probe5_row_step_matches_jax(how, shape):
    S, A, B, reps = shape
    want = _jax(jprobe5.make_row_step, 21, reps, S, A, B, how)[2]
    got = _port(probe5.make_row_step, 21, reps, S, A, B, how)[2]
    assert got == want


@pytest.mark.parametrize("how", probe5.HOWS)
def test_probe5_select_matches_jax(how):
    rng = np.random.default_rng(8)
    rows = rng.integers(-1000, 1000, (40, 32)).astype(np.int32)
    c = rng.integers(0, 32, 40).astype(np.int32)
    want = np.asarray(jprobe5._select(jnp.asarray(rows), jnp.asarray(c), 32, how))
    got = probe5._select(torch.from_numpy(rows), torch.from_numpy(c), 32, how).numpy()
    np.testing.assert_array_equal(got, want)
    # logtree halves from the top on c's bits from the bottom: c bit-reversed
    col = c if how == "onehot" else probe5.bitrev(torch.from_numpy(c), 32).numpy()
    np.testing.assert_array_equal(got, rows[np.arange(40), col])


@pytest.mark.parametrize("which", ["probe_xla_row_gather_width", "probe_hbm_row_gather_width"])
def test_probe6_width_probes_match_jax(which, monkeypatch):
    sums = []

    def record(fn, *args, reps=3):
        sums.append(int(fn(*args)))
        return 1.0

    monkeypatch.setattr(jprobe6, "_timeit", record)
    kw = dict(S=48, B=24, T=5)
    getattr(jprobe6, which)(**kw)
    got = getattr(probe6, which)(**kw, device="cpu")
    widths = probe6.WIDTHS_XLA if "xla" in which else probe6.WIDTHS_HBM
    assert list(got) == list(widths)
    assert [total for _, total in got.values()] == sums


# ----------------------------------------------------- the kernel's lanes


def _batch(words: int, G: int) -> int:
    """kB: a lane's words rounded up to a power of two, at most 16."""
    per = -(-words // G)
    for kb in (1, 2, 4, 8):
        if per <= kb:
            return kb
    return 16


def _model_step(row: np.ndarray, c: int, G: int, how: str) -> int:
    """One step of a chain as the kernel's lanes make it (uint32 words)."""
    A = row.shape[0]
    vec = A % 4 == 0
    words = A // 4 if vec else A
    word = (lambda w: row[4 * w: 4 * w + 4]) if vec else (lambda w: row[w: w + 1])
    kb = _batch(words, G)
    c = min(c, A - 1)
    cw = c // 4 if vec else c
    kept = [0] * G
    for g in range(G):
        acc = 0
        for base in range(g, words, G * kb):
            for j in range(kb):
                w = base + j * G
                if w >= words:
                    continue
                if how == "sum":
                    acc += int(word(w).astype(np.int64).sum())
                elif w == cw:
                    acc = int(word(w)[c % 4 if vec else 0])
        kept[g] = acc & 0xFFFFFFFF
    if how == "sum":
        return sum(kept) & 0xFFFFFFFF
    return kept[cw % G]


@pytest.mark.parametrize("how", kp.HOWS)
@pytest.mark.parametrize("A", [1, 27, 28, 1024])
def test_twin_matches_a_model_of_the_lanes(A, how):
    rng = np.random.default_rng(A)
    S, B, reps = 23, 9, 5
    tab = rng.integers(0, 1 << 32, (S, A), dtype=np.uint64).astype(np.uint32)
    tab[1] = 0xFFFFFFFF
    s0 = rng.integers(0, 2 * S, B).astype(np.int32)  # some past the last row
    cols = rng.integers(0, A + 3, (3, B)).astype(np.int32)  # some past the row
    for signed, mod in ((False, S), (False, (1 << 32) - 1), (True, S), (True, (1 << 31) - 1)):
        t = torch.from_numpy(tab.view(np.int32) if signed else tab)
        if not signed:
            t = t.view(torch.uint32)
        for add_r in (False, True):
            want = []
            for b in range(B):
                s = int(s0[b]) & 0xFFFFFFFF
                for r in range(reps):
                    row = tab[min(s, S - 1)]
                    v = {_model_step(row, int(cols[r % 3, b]), G, how)
                         for G in kp.ROW_GROUPS}
                    assert len(v) == 1  # every group size makes the same value
                    x = (v.pop() + (r if add_r else 0)) & 0xFFFFFFFF
                    if signed:
                        x = x - (1 << 32) if x >= 1 << 31 else x
                    s = x % mod  # Python's % is floor modulo
                want.append(s)
            got = kp.row_select(t, torch.from_numpy(s0), torch.from_numpy(cols), reps, how, mod,
                                add_r=add_r)
            assert got.dtype == torch.int32 and got.shape == (B,)
            np.testing.assert_array_equal(got.numpy().view(np.uint32).astype(np.int64), want)


def test_row_group_covers_every_width():
    """The kernel's batches (16-byte words where A % 4 == 0) reach every word
    of rows up to 1,024 words at the rule's group."""
    for A in range(1, 1025):
        G = kp.row_group(A)
        words = A // 4 if A % 4 == 0 else A
        kb = _batch(words, G)
        seen = {base + j * G for g in range(G) for base in range(g, words, G * kb)
                for j in range(kb) if base + j * G < words}
        assert seen == set(range(words)), A


def test_refusals():
    t = torch.zeros((4, 8), dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    c = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="how"):
        kp.row_select(t, s, c, 1, "max", 4)
    with pytest.raises(ValueError, match="needs cols"):
        kp.row_select(t, s, None, 1, "select", 4)
    with pytest.raises(ValueError, match="cols must be"):
        kp.row_select(t, s, torch.zeros((2, 4), dtype=torch.int32), 1, "select", 4)
    with pytest.raises(ValueError, match="mod"):
        kp.row_select(t, s, c, 1, "select", 1 << 31)  # an int32 table's mod
    kp.row_select(t.view(torch.uint32), s, c, 1, "select", 1 << 31)  # a uint32 one's
    with pytest.raises(ValueError, match="group"):
        kp.row_select(t, s, c, 1, "sum", 4, group=3)
    with pytest.raises(TypeError):
        kp.row_select(t.float(), s, c, 1, "sum", 4)
    w = torch.zeros((2, 5), dtype=torch.uint8)
    with pytest.raises(TypeError, match="windows"):
        kp.window_chain(t.reshape(-1), w.to(torch.int64), 8)
    with pytest.raises(ValueError, match="stride"):
        kp.window_chain(t, w, 4)  # a 2-D table's stride is its width
    with pytest.raises(ValueError, match="1-D table with a stride"):
        kp.window_chain(t.reshape(-1), w)
    assert int(kp.window_chain(t, w)) == 0
