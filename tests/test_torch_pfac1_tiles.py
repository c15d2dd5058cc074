"""The PFAC v1 walk (``csrc/pfac1_walk.cuh``): a numpy model of the kernel's
decomposition, held against the wrapper's plain twin
(``kernels.scan_pfac.pfac1_planes_plain``) and the JAX
``ops/scan_pfac.pfac_bitplanes`` on ``tests/dict_corpus.py`` dictionaries
and synthetic tries, at edge lane counts, depths and class widths; and the
rule that picks the staged tables and the launch,
``kernels.scan_pfac.pfac1_plan``.

The staged tables, built by each block from ``trie_next`` and ``is_match``
where the two-level table fits: the root row and the two-level table
``trie[trie[0][c0]][c1]``, each entry a state with its match flag in bit
31.  A walk's first two steps read them (else its first reads the root row
from the trie), each later step one trie load and the state's match flag.
Thread t of a block takes start t of each of the block's runs of
``V1_THREADS`` starts, grid-stride.  Tables, classes and planes are
integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_pfac as jax_pfac
from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_pfac
from dict_corpus import dict_corpus, dict_words

SMS = 132
STATE = (1 << 31) - 1


def staged_tables(trie: np.ndarray, is_match: np.ndarray):
    """The block's staged tables: the root row and the two-level table,
    each entry a state with its match flag in bit 31."""
    m = is_match[:trie.shape[0]].astype(np.int64)
    root = trie[0] | (m[trie[0]] << 31)
    two = trie[trie[0]] | (m[trie[trie[0]]] << 31)
    return root, two


def walk(trie, is_match, cls, starts, depth, num_planes, plan):
    """The walks of ``starts`` (offsets into ``cls``, the classes as the
    kernel reads them) with the plan's staged tables: planes int64[P,
    len(starts)] and each walk's loop passes (its trie loads past the staged
    levels, plus one to end)."""
    trie = np.asarray(trie).astype(np.int64) & 0xFFFFFFFF
    S, A = trie.shape
    flat = trie.reshape(-1)
    dead = S - 1
    root, two = staged_tables(trie, np.asarray(is_match))

    def match(s):
        return np.asarray(is_match)[s].astype(np.int64)

    cnt = len(starts)
    c = lambda k: cls[starts + k]  # noqa: E731
    c0 = np.minimum(c(0), A - 1)
    if plan.two_level:
        st, word = root[c0] & STATE, root[c0] >> 31
    else:
        st = flat[c(0)]
        word = match(st)
    kk = np.ones(cnt, dtype=np.int64)
    if plan.two_level and depth > 1:
        go = st != dead
        e = two[c0, np.minimum(c(1), A - 1)]
        st = np.where(go, e & STATE, st)
        word = word | np.where(go, (e >> 31) << 1, 0)
        kk = np.where(go, 2, 1)
    out = np.zeros((num_planes, cnt), dtype=np.int64)
    passes = np.ones(cnt, dtype=np.int64)
    while True:
        live = (kk < depth) & (st != dead)
        if not live.any():
            break
        cross = live & (kk % 32 == 0)
        out[(kk[cross] >> 5) - 1, np.nonzero(cross)[0]] = word[cross]
        word = np.where(cross, 0, word)
        i = np.nonzero(live)[0]
        st[i] = flat[st[i] * A + cls[starts[i] + kk[i]]]
        word[i] |= match(st[i]) << (kk[i] % 32)
        kk[i] += 1
        passes[i] += 1
    out[(kk - 1) >> 5, np.arange(cnt)] = word  # later planes stay 0
    return out, passes


def stride_walk(trie, is_match, cls_padded, depth, num_planes, plan, threads=kpf.V1_THREADS):
    """The grid stride: block b's thread t walks start (b + g j) threads + t,
    each start once; the warp's plane words leave together."""
    cls = np.asarray(cls_padded).astype(np.int64)
    n = len(cls) - depth
    run = threads
    b, t, j = np.meshgrid(np.arange(plan.grid), np.arange(threads),
                          np.arange(-(-n // (run * plan.grid))), indexing="ij")
    starts = ((b + plan.grid * j) * run + t).reshape(-1)
    starts = np.sort(starts[starts < n])
    assert np.array_equal(starts, np.arange(n))
    return walk(trie, is_match, cls, starts, depth, num_planes, plan)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32).astype(np.int64)


def _classes(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr.astype(dtype))
    if dtype == "uint16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(arr)


def _plans(trie, cls_t, depth):
    """The rule's plan and the same grid in the other staged form."""
    plan = kpf.pfac1_plan(cls_t.numel() - depth, trie.shape[1], SMS)
    other = not plan.two_level
    return plan, kpf.Plan(plan.grid, other, kpf.pfac1_smem(trie.shape[1], other))


_TABLES = {}


def dictionary(n_words: int, seed: int):
    """A dict_corpus dictionary's JAX-compiled matcher and its padded v1
    tables (numpy), cached."""
    key = (n_words, seed)
    if key not in _TABLES:
        words = dict_words(n_words, seed)
        ref = jax_compile(words, "ac", True)
        jdev = jax_pkg.models.matchers._DeviceTables(ref)
        _TABLES[key] = (words, ref, np.array(jdev.trie_next), np.array(jdev.is_match))
    return _TABLES[key]


CASES = [  # (dictionary words, its seed, units, depth or None (max_depth), class dtype)
    (300, 1, 1, None, "uint8"),
    (300, 1, 31, None, "uint8"),
    (300, 1, 33, 4, "uint16"),
    (300, 1, kpf.V1_THREADS - 1, None, "int32"),
    (300, 1, kpf.V1_THREADS * 8, 12, "uint8"),
    (300, 1, kpf.V1_THREADS * 8 + 1, 33, "uint8"),
    (2000, 2, 20001, 32, "uint16"),
    (2000, 2, 65537, 64, "uint8"),
]


@pytest.mark.parametrize("n_words, seed, units, depth, dtype", CASES)
def test_model_equals_twin_and_jax(n_words, seed, units, depth, dtype):
    """The kernel's model at the rule's plan (the two-level table) == the
    twin == the JAX v1 walk on a dictionary-corpus text, at lane counts
    around a block's run of starts, depths 4 to 64 (one and two planes) and
    uint8, uint16 and int32 classes; the root read from the trie == the
    twin too."""
    words, ref, trie, is_match = dictionary(n_words, seed)
    text = dict_corpus(words, units, seed)[:units]
    cls = ref.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    d = max(ref.max_depth, 1) if depth is None else depth
    P = (d + 31) // 32
    padded = scan_pfac.pad_classes(cls, d)
    c = _classes(padded, dtype)
    trie_t, m_t = torch.from_numpy(trie), torch.from_numpy(is_match)
    want = _u32(kpf.pfac1_planes_plain(trie_t, m_t, c, d, P))
    jax_planes = np.asarray(jax_pfac.pfac_bitplanes(jnp.asarray(trie), jnp.asarray(is_match),
                                                    jnp.asarray(padded.astype(np.int32)), d, P))
    np.testing.assert_array_equal(want, jax_planes.astype(np.int64))
    plan, other = _plans(trie, c, d)
    assert plan.two_level
    for p in (plan, other):
        np.testing.assert_array_equal(stride_walk(trie, is_match, padded, d, P, p)[0], want)


def synthetic(rng, S, A, live, match):
    """chip_smoke's synthetic trie: the last row an absorbing dead state that
    emits nothing; class 0 (PAD_CLASS) always dead."""
    dead = S - 1
    trie = np.where(rng.random((S, A)) < live, rng.integers(0, dead, (S, A)), dead)
    trie[:, 0] = dead
    trie[dead] = dead
    m = rng.random(S) < match
    m[dead] = False
    return trie.astype(np.int32), m


@pytest.mark.parametrize("S, A, depth", [
    (512, 32, 12), (512, 32, 64), (512, 128, 33), (64, 5000, 12), (300, 32, 200)])
def test_models_on_synthetic_tries(S, A, depth):
    """Seeded tries with an absorbing dead state: the model == the twin in
    both staged forms (the rule's and the other), seven planes at depth
    200; no walk passes its loop more than its depth past the staged
    levels."""
    rng = np.random.default_rng(S + A + depth)
    trie, m = synthetic(rng, S, A, 0.93, 0.3)
    cls = rng.integers(1, A, 3 * kpf.V1_THREADS + 7)
    padded = scan_pfac.pad_classes(cls, depth)
    P = (depth + 31) // 32
    c = _classes(padded, "uint16")
    want = _u32(kpf.pfac1_planes_plain(torch.from_numpy(trie), torch.from_numpy(m), c, depth, P))
    for plan in _plans(trie, c, depth):
        got, passes = stride_walk(trie, m, padded, depth, P, plan)
        np.testing.assert_array_equal(got, want)
        assert passes.max() <= depth - (2 if plan.two_level else 1) + 1 and passes.min() >= 1


def test_two_level_table_absorbs_the_dead_state():
    """The staged two-level table of a trie whose first step dies: its row is
    the dead state, emitting nothing, so a walk that dies at its first step
    reads the same from either level."""
    rng = np.random.default_rng(7)
    trie, m = synthetic(rng, 512, 32, 0.8, 0.3)
    dead = trie.shape[0] - 1
    root, two = staged_tables(trie.astype(np.int64), m)
    died = (root & STATE) == dead
    assert died.any() and (root[died] >> 31 == 0).all()
    assert ((two[died] & STATE) == dead).all() and (two[died] >> 31 == 0).all()
    live = ~died
    np.testing.assert_array_equal(two[live] & STATE, trie[trie[0][live]])


def test_plan_rule():
    """``pfac1_plan``: the 10k cell's shape; the staged tables where the
    two-level table fits and not past; the shared memory of
    ``pfac1_smem``; the grid within the starts' runs and the card's
    blocks."""
    p = kpf.pfac1_plan(32 << 20, 32, SMS)
    assert p == (kpf.V1_BLOCKS_PER_SM * SMS, True, 128 + 4096)
    assert kpf.pfac1_plan(1000, 64, SMS).two_level  # 16 KB: fits
    assert kpf.pfac1_plan(1000, 65, SMS) == (2, False, 0)
    assert kpf.pfac1_plan(1000, 4097, SMS) == (2, False, 0)
    assert kpf.pfac1_plan(1, 32, SMS).grid == 1
    assert kpf.pfac1_plan(kpf.V1_THREADS + 1, 32, SMS).grid == 2
    for stride in (1, 2, 27, 32, 64, 65, 4096, 4097):
        plan = kpf.pfac1_plan(10**6, stride, SMS)
        assert plan.smem == kpf.pfac1_smem(stride, plan.two_level) <= 256 + 16_384


def test_wrapper_on_cpu_is_the_twin():
    """On CPU tensors ``pfac1_planes`` returns the twin, for classes 4 bytes
    off a 16-byte boundary too, and launches nothing."""
    _, ref, trie, is_match = dictionary(300, 1)
    rng = np.random.default_rng(3)
    cls = rng.integers(0, ref.num_classes, 5000)
    padded = scan_pfac.pad_classes(cls, 12).astype(np.int32)
    flat = torch.zeros(padded.size + 1, dtype=torch.int32)
    c = flat[1:]
    c.copy_(torch.from_numpy(padded))
    before = launches["pfac1_planes"]
    got = kpf.pfac1_planes(torch.from_numpy(trie), torch.from_numpy(is_match), c, 12, 1,
                           trie.shape[0] - 1)
    plan = _plans(trie, c, 12)[0]
    np.testing.assert_array_equal(_u32(got), stride_walk(trie, is_match, padded, 12, 1, plan)[0])
    assert launches["pfac1_planes"] == before
