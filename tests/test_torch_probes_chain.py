"""The probes' lookup chain (``chain_gather``, B19) and one-hot product
(``onehot_mma``, B19) on the CPU: plain models of the kernels'
decompositions against the twins that the wrappers run for CPU tensors and
against the JAX probes of ``tools/probes/`` (Pallas in interpret mode), and
the rules that shape the kernels (``shared_copies``, ``onehot_slab``).

The register form of the chain packs each lane's four entries as bytes of
one word (only a reduced entry steers a chain: ``v & (T - 1)``, ``min(v, T -
1)`` or ``v % mod``), so a step is one shuffle and one byte extract, and the
load op reads its last step's full value from the table.  The shared form
stages R interleaved copies, word ``x R + lane % R`` holding entry x.  The
one-hot product builds its A fragments in registers (only the k-tile that
holds a row's one is not zero) and reads its slab through a wgmma
descriptor of 8 x 8 core matrices.  The edges are the ones the card is
checked at; everything compared is an integer: exact equality.
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
import probe as jprobe  # noqa: E402
import probe6 as jprobe6  # noqa: E402

from ahocorasick_tpu_torch.kernels import probes as kp  # noqa: E402
from ahocorasick_tpu_torch.kernels.build import launches  # noqa: E402
from ahocorasick_tpu_torch.probes import probe  # noqa: E402

M32 = 0xFFFFFFFF
REGISTER_T = (1, 2, 127, 128)
SHARED_T = (129, 1816, 1817, 4096, 57344, 58112)
CHAINS = (1, 31, 33, 100)
REPS = (0, 1, 6)


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


def _ops(T: int) -> list:
    ops = [("load", None), ("load_mod", 1), ("load_mod", T)]
    return [("add", None), ("add_r", None), *ops] if T & (T - 1) == 0 else ops


def _steer(v, op, last, mod):
    return v & last if op in ("add", "add_r") else np.minimum(v, last) if op == "load" else v % mod


def _advance(i, v, r, op, last, mod):
    if op == "add":
        return (i + v) & last
    if op == "add_r":
        return (i + v + r) & last
    return v if op == "load" else v % mod


def _address(i, op, last):
    return i & last if op in ("add", "add_r") else np.minimum(i, last)


def packed_model(tab, idx, reps, op, mod=None):
    """The register form (T <= 128) as the kernel runs it: lane l's word
    holds the steering bytes of entries l, l + 32, l + 64, l + 96; the start
    is clamped (or masked) once, after which every value is an address below
    T; a step reads lane a % 32's word and its byte a // 32; the load op's
    last step reads the table's full value."""
    t = tab.astype(np.int64) & M32
    T, last = t.size, t.size - 1
    e = np.arange(128)
    steer = np.where(e < T, _steer(t[np.minimum(e, last)], op, last, mod), 0)
    assert steer.max() < 256
    packed = (steer.reshape(4, 32) << (8 * np.arange(4))[:, None]).sum(axis=0)
    i = idx.astype(np.int64) & M32
    if reps == 0:
        return i
    i = _address(i, op, last)
    for r in range(reps - 1 if op == "load" else reps):
        assert i.max() <= last
        i = _advance(i, (packed[i % 32] >> (8 * (i >> 5))) & 0xFF, r, op, last, mod)
    return t[i] if op == "load" else i


def bank_model(tab, idx, reps, op, mod=None):
    """The shared form as the kernel runs it: ``shared_copies(T)`` copies,
    word ``x R + lane % R`` holding entry x's steering value scaled to a
    byte offset (the load ops: the offset of the next word, the lane's copy
    included; the add ops: the scaled ``v & (T - 1)``), chain c on lane c %
    32.  Returns the chains' values and the most lanes of a warp's load that
    share a bank with different words (1: no conflict).  With one copy the
    entries stay as they are and a step reduces the entry it read, as the
    first design did."""
    t = tab.astype(np.int64) & M32
    T, last = t.size, t.size - 1
    R = kp.shared_copies(T)
    if R == 1:
        i = idx.astype(np.int64) & M32
        for r in range(reps):
            i = _advance(i, t[_address(i, op, last)], r, op, last, mod)
        return i, None
    s2 = R.bit_length() - 1 + 2
    w = np.arange(T * R)
    staged = _steer(t[w // R], op, last, mod) << s2
    if op in ("load", "load_mod"):
        staged |= (w % R) << 2
    i = idx.astype(np.int64) & M32
    if reps == 0:
        return i, 1
    mine = (np.arange(i.size) % 32 % R) << 2
    span = last << s2
    at = (_address(i, op, last) << s2) | mine
    worst = 1
    for r in range(reps - 1 if op == "load" else reps):
        word = at >> 2
        for c in range(0, i.size, 32):
            words, banks = word[c: c + 32], word[c: c + 32] % 32
            worst = max(worst, max(len(np.unique(words[banks == b])) for b in np.unique(banks)))
        v = staged[word]
        if op == "add":
            at = ((at + v) & span) | mine
        elif op == "add_r":
            at = ((at + v + (r << s2)) & span) | mine
        else:
            at = v
    i = at >> s2
    return (t[i] if op == "load" else i), worst


def _inputs(T, n, seed):
    """A table half below T and half any 32-bit word, and starts below 2 T
    or any 32-bit word, as uint32."""
    rng = np.random.default_rng(seed)
    tab = np.where(rng.random(T) < 0.5, rng.integers(0, T, T),
                   rng.integers(0, 1 << 32, T)).astype(np.uint32)
    idx = np.where(rng.random(n) < 0.8, rng.integers(0, 2 * T, n),
                   rng.integers(0, 1 << 32, n)).astype(np.uint32)
    return tab, idx


def _twin(tab, idx, reps, op, mod):
    got = kp.chain_gather(torch.from_numpy(tab.view(np.int32)),
                          torch.from_numpy(idx.view(np.int32)), reps, op, mod=mod)
    return got.numpy().view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("T", REGISTER_T)
def test_packed_register_lookup_equals_the_twin(T):
    """Every op at every chain count and step count, the bytes of the
    register form against ``chain_gather_plain``."""
    for op, mod in _ops(T):
        for n in CHAINS:
            tab, idx = _inputs(T, n, seed=T * 7 + n)
            for reps in REPS:
                want = _twin(tab, idx, reps, op, mod)
                np.testing.assert_array_equal(packed_model(tab, idx, reps, op, mod), want,
                                              err_msg=f"T={T} {op} mod={mod} n={n} reps={reps}")


def test_packed_load_keeps_the_full_last_value():
    """Entries >= 256 and >= T: the clamped bytes steer, the last step's
    value is the table's word."""
    tab = np.array([300, 0xFFFFFFFF, 1, 70000], np.uint32)
    idx = np.array([0, 2, 5, 1 << 31], np.uint32)
    got = packed_model(tab, idx, 3, "load")
    np.testing.assert_array_equal(got, _twin(tab, idx, 3, "load", None))
    assert got.max() > 255


@pytest.mark.parametrize("T", SHARED_T)
def test_bank_spread_lookup_equals_the_twin(T):
    """The interleaved copies' addresses against ``chain_gather_plain``;
    with 32 copies no two lanes of a warp share a bank."""
    for op, mod in _ops(T):
        for n in (33, 100):
            tab, idx = _inputs(T, n, seed=T + n)
            got, worst = bank_model(tab, idx, 4, op, mod)
            np.testing.assert_array_equal(got, _twin(tab, idx, 4, op, mod),
                                          err_msg=f"T={T} {op} mod={mod} n={n}")
            if kp.shared_copies(T) == 32:
                assert worst == 1


def test_lane_gather_jax_equals_the_packed_model(recorded):
    """probe.py:70, the 128-entry lane gather (the add op on row 0 of an (8,
    128) draw): the JAX probe == the packed register model."""
    np.random.seed(21)
    _, out = jprobe.probe_lane_gather(reps=5, B=8)
    np.random.seed(21)
    tab = np.random.randint(0, 128, (8, 128), np.int32)
    idx = np.random.randint(0, 128, (8, 128), np.int32)
    want = packed_model(tab[0], idx.reshape(-1), 5, "add").reshape(8, 128)
    np.testing.assert_array_equal(np.asarray(out), want)
    np.testing.assert_array_equal(recorded[0], want)


def test_load_mod_jax_equals_the_bank_model(recorded, capsys):
    """probe6.py:120 (``k_flat_elem``, ``k_take``: ``s <- tab[s] % S`` on a
    flat uint32 table) at a 512 x 32 table: each JAX kernel's output == the
    shared form's interleaved copies (two, at 16,384 entries)."""
    S, A, steps = 512, 32, 8
    jprobe6.probe_pallas_gathers(S=S, A=A, T=steps)
    capsys.readouterr()
    rng = np.random.default_rng(0)
    flat = rng.integers(0, S * A, size=S * A, dtype=np.int64).astype(np.uint32)
    idx0 = rng.integers(0, S, size=(8, 128)).astype(np.uint32)
    assert kp.shared_copies(S * A) == 2
    got, _ = bank_model(flat, idx0.reshape(-1), steps, "load_mod", S)
    firsts = recorded[::5]  # _timeit runs each kernel 5 times
    for want in firsts[:2]:
        np.testing.assert_array_equal(got.reshape(8, 128), want)
    np.testing.assert_array_equal(got, _twin(flat, idx0.reshape(-1), steps, "load_mod", S))


@pytest.mark.parametrize("T", range(1, 70001, 997))
def test_shared_copies_rule(T):
    R = kp.shared_copies(T)
    assert R in (1, 2, 4, 8, 16, 32)
    assert R == 1 or R * 4 * T <= kp.SHARED_BYTES
    assert R == 32 or 2 * R * 4 * T > kp.SHARED_BYTES


def test_shared_copies_at_the_edges():
    assert [kp.shared_copies(T) for T in (1, 128, 1816, 1817, 4096, 57344, 58112)] == \
        [32, 32, 32, 16, 8, 1, 1]


@pytest.mark.parametrize("T", (16, 64, 2048, 4096))
@pytest.mark.parametrize("ncols", (32, 64, 128, 160, 512))
@pytest.mark.parametrize("B", (1, 63, 65, 1024, 4096))
def test_onehot_slab_rule(T, ncols, B):
    """Two warpgroups wherever there are two k-tiles to split; groups of
    16 k-tiles that divide a warpgroup's, else one; a block every 64 rows
    and 16 columns; the block's shared memory always fits."""
    wgs, group, blocks = kp.onehot_slab(T, ncols, B)
    assert wgs == (2 if T >= 32 else 1)
    per = T // 16 // wgs
    assert group in (1, 16) and per % group == 0
    assert group == 16 or per < 16
    assert blocks == -(-B // 64) * ncols // kp.ONEHOT_SLAB
    assert kp.onehot_shared(T, wgs) <= kp.SHARED_BYTES


def test_onehot_slab_fills_the_card_at_the_timed_shape():
    assert kp.onehot_slab(2048, 128, 1024) == (2, 16, 128)
    assert kp.onehot_slab(256, 32, 1) == (2, 1, 2)
    assert kp.onehot_slab(512, 32, 1) == (2, 16, 2)
    assert kp.onehot_slab(16, 32, 1) == (1, 1, 2)


def _onehot_fragments(s: int, T: int):
    """The kernel's A registers of one row for lanes t4 = 0 .. 3: its one's
    k-tile (none past T) and the lo / hi fp16 pairs, decoded back into the
    16 columns of that tile."""
    tile = s >> 4 if s < T else None
    cols = np.zeros(16)
    k = s & 15
    for t4 in range(4):
        one = (0x3C000000 if k & 1 else 0x3C00) if ((k >> 1) & 3) == t4 else 0
        lo, hi = (one, 0) if k < 8 else (0, one)
        for reg, base in ((lo, 2 * t4), (hi, 2 * t4 + 8)):
            for half in (0, 1):
                bits = (reg >> (16 * half)) & 0xFFFF
                cols[base + half] += np.array([bits], np.uint16).view(np.float16)[0]
    return tile, cols


@pytest.mark.parametrize("T", (16, 64, 2048))
def test_onehot_fragments_hold_one_one(T):
    """Across a row's four lanes the A fragments hold exactly one 1.0, at
    column s % 16 of k-tile s // 16; a start past the table holds none."""
    for s in [*range(0, T, max(T // 64, 1)), T - 1, T, 2 * T - 1]:
        tile, cols = _onehot_fragments(s, T)
        if s >= T:
            assert tile is None
            continue
        assert tile == s >> 4
        want = np.zeros(16)
        want[s & 15] = 1.0
        np.testing.assert_array_equal(cols, want)


@pytest.mark.parametrize("T", (16, 64, 2048, 4096))
def test_onehot_slab_layout_matches_its_descriptor(T):
    """The slab's staging (16-byte chunk q: rows 8 (q // T) + q % 8 of the
    slab, k = 8 ((q // 8) % (T / 8)) ..) puts element (n, k) where k-tile
    k // 16's descriptor reads it: 256 bytes a k-tile, 128 bytes (lbo)
    between the core matrices along K, 16 T bytes (sbo) along N, 16 bytes a
    row of a core matrix."""
    cols = kp.ONEHOT_SLAB
    kb = T // 8
    q = np.arange(cols * kb)
    n = (q // (8 * kb)) * 8 + (q & 7)
    staged = np.empty(cols * T, np.int64)  # 2-byte slots
    for j in range(8):
        staged[8 * q + j] = n * T + ((q >> 3) % kb) * 8 + j
    nn, kk = np.meshgrid(np.arange(cols), np.arange(T), indexing="ij")
    byte = (kk // 16) * 256 + (nn >> 3) * (16 * T) + ((kk % 16) >> 3) * 128 + (nn & 7) * 16 \
        + (kk & 7) * 2
    np.testing.assert_array_equal(staged[byte // 2], nn * T + kk)


@pytest.mark.parametrize("T", (16, 64))
@pytest.mark.parametrize("B", (1, 16, 65))
def test_onehot_twin_equals_jax(recorded, T, B):
    """probe.py:192 (P4, ``probe_mxu_onehot``): the port's probe on the twin
    == the JAX probe run in interpret mode, from the same seed."""
    np.random.seed(30 + B)
    _, out = jprobe.probe_mxu_onehot(T=T, reps=3, B=B)
    got = probe.probe_mxu_onehot(T=T, reps=3, B=B, rng=np.random.RandomState(30 + B),
                                 device="cpu")[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))


def test_onehot_model_drives_from_column_zero():
    """The kernel's decomposition of a step: every row's one-hot driven by
    its column-0 chain advanced from column 0 of the table, ``s <- (s +
    tab[s, 0]) & (T - 1)`` (nothing added past the table), and the product
    column by column == the twin, column 0 of the product == the chain."""
    rng = np.random.default_rng(31)
    T, B, ncols, reps = 64, 65, 64, 5
    tab = rng.integers(0, 2048, (T, ncols)).astype(np.float32)
    idx = rng.integers(0, 2 * T, (B, ncols)).astype(np.int64)
    v, s = idx.copy(), idx[:, 0].copy()
    for _ in range(reps):
        onehot = (np.arange(T)[None, :] == s[:, None]).astype(np.float64)
        v = (v + (onehot @ tab).astype(np.int64)) & (T - 1)
        s = (s + np.where(s < T, tab[np.minimum(s, T - 1), 0].astype(np.int64), 0)) & (T - 1)
        np.testing.assert_array_equal(v[:, 0], s)
    got = kp.onehot_mma(kp.onehot_table(torch.from_numpy(tab)),
                        torch.from_numpy(idx.astype(np.int32)), reps)
    np.testing.assert_array_equal(got.numpy(), v)


def test_cpu_tensors_launch_nothing():
    before = dict(launches)
    tab, idx = _inputs(128, 40, seed=1)
    kp.chain_gather(torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx.view(np.int32)), 3,
                    "load", placement="shfl")
    tab_h = kp.onehot_table(torch.zeros((16, 32)))
    kp.onehot_mma(tab_h, torch.zeros((3, 32), dtype=torch.int32), 2)
    assert launches == before


def test_onehot_wrapper_takes_what_its_slab_fits():
    """T up to 4,096 (a 16-column slab and column 0 fit 227 KB); 8,192 and
    columns off a multiple of 32 are refused."""
    kp.onehot_mma(kp.onehot_table(torch.zeros((4096, 32))),
                  torch.zeros((2, 32), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="slab"):
        kp.onehot_mma(kp.onehot_table(torch.zeros((8192, 32))),
                      torch.zeros((2, 32), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        kp.onehot_mma(kp.onehot_table(torch.zeros((64, 48))),
                      torch.zeros((2, 48), dtype=torch.int32), 1)
