"""The table-sharded scan as the ranks of a process group run it, in one
process: ``kernels.table_sharded.group_scan`` over the twins of
``table_sharded_step`` and its class-major prep ``step_classes`` (CPU
tensors), every rank of the model axis simulated and the per-step
``all_reduce`` replaced by the sum of their word buffers, vs the JAX
package's ``_table_sharded_run`` on the 8-device CPU mesh of
``tests/conftest.py``: all five modes on the 1-axis mesh of 8 and the 2-axis
(2, 4) mesh, on the tables of ``tests/test_torch_table_sharded.py``, at the
lanes of ``step_segments`` and at K = 8 and 16 forced.  Then the 2-axis
group layout's shape rule and refusals (a process group of one rank in this
process, whose one-rank model axis scans with ``table_sharded_scan`` and
never the step loop), a state past the last shard, the ragged last segment,
the prep's twin against direct indexing, and the step wrapper's refusals.
Everything compared is an integer, so every comparison is exact."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import table_sharded as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_sharding import CPU, _np
from test_torch_table_sharded import MODES, _jax_run, _jmesh, _table

CHUNK = 64


def _sum_ranks(words):
    """The all_reduce of the simulated ranks: at most one rank's word is not
    0 (the rank that owns the lane's state), so the int32 sum is exact."""
    stack = torch.stack([w.view(torch.int32) for w in words])
    assert int((stack != 0).sum(0).max()) <= 1
    total = stack.sum(0, dtype=torch.int32)
    for w in words:
        w.view(torch.int32).copy_(total)


def _shards(table: np.ndarray, n_model: int):
    rows_per = -(-table.shape[0] // n_model)
    padded = np.pad(table, ((0, rows_per * n_model - table.shape[0]), (0, 0)))
    return [(k, port_sh._shard_tensor(padded[k * rows_per: (k + 1) * rows_per], CPU))
            for k in range(n_model)]


def _simulated(table, windows, halo, sb, shape, mode):
    """The group form on a ``shape = (n_data, n_model)`` layout: data slice i
    of the windows scanned by the n_model ranks of model row i; the counts
    summed and the planes concatenated over the data axis, as the ranks'
    collectives do.  Every rank of a row returns the same result."""
    n_data, n_model = shape
    ranks = _shards(table, n_model)
    per = windows.shape[0] // n_data
    parts = []
    for i in range(n_data):
        got = kernels.group_scan(ranks, windows[i * per: (i + 1) * per], halo, sb, mode,
                                 _sum_ranks)
        assert len(got) == n_model
        for g in got[1:]:
            assert torch.equal(g.view(torch.int32) if g.dim() else g,
                               got[0].view(torch.int32) if g.dim() else got[0])
        parts.append(got[0])
    if mode in ("count", "count_packed"):
        return sum(int(p) for p in parts)
    return torch.cat([p.view(torch.int32) for p in parts], dim=1).view(torch.uint32)


def _windows(table, cls, halo, chunk=CHUNK):
    A = table.shape[1]
    return port_sb.classes_to_device(port_sb.chunk_classes(cls, chunk, halo, A), A, CPU)


@functools.lru_cache(maxsize=None)
def _jax_run_2d(name, mode):
    table, cls, halo, sb = _table(name)
    return np.asarray(jax_sh._table_sharded_run(table, cls, halo, sb, _jmesh((2, 4)), CHUNK,
                                                mode))


def _force_k(monkeypatch, k):
    """``step_segments`` at most ``k`` lanes a window, whatever the windows'
    number (None: the rule as it stands)."""
    if k is not None:
        monkeypatch.setattr(kernels, "STEP_MAX_K", dict.fromkeys(kernels.MODES, k))
        monkeypatch.setattr(kernels, "STEP_MAX_LANES", 1 << 40)


@pytest.mark.parametrize("k", [None, 8, 16], ids=["rule", "K8", "K16"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["model8", "data2_model4"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["packed", "count_packed", "wwl"])
def test_step_loop_equals_jax(name, mode, shape, k, monkeypatch):
    table, cls, halo, sb = _table(name)
    want = _jax_run(name, mode) if shape == (1, 8) else _jax_run_2d(name, mode)
    _force_k(monkeypatch, k)
    windows = _windows(table, cls, halo)
    B, W = windows.shape
    K, L = kernels.step_segments(B // shape[0], W - halo, halo, mode)
    assert K == (1 if halo == 0 else k or kernels.STEP_MAX_K[mode]) and K * L == W - halo
    before = dict(launches)
    got = _simulated(table, windows, halo, sb, shape, mode)
    assert launches == before  # the twin counts no launches
    if mode in ("count", "count_packed"):
        assert got == int(want)
        assert name == "wwl" or got > 0
    else:
        assert got.dtype == torch.uint32
        assert tuple(got.shape) == want.shape == (1, -(-len(cls) // CHUNK) * CHUNK)
        np.testing.assert_array_equal(_np(got), want)
        assert want.any()


# ------------------------------------------------------------------ the edges


def test_group_layout_follows_the_jax_shape_rule():
    for n in range(1, 9):
        want = jax_sh.dp_tp_mesh(np.arange(n)).devices.shape
        assert port_sh._dp_tp_shape(n, None, "ranks") == want
        assert port_sh._dp_tp_shape(n, want, "ranks") == want
    for n, shape in ((8, (3, 2)), (8, (0, 8)), (4, (4, 0)), (6, (2, 2))):
        with pytest.raises(ValueError, match=f"does not hold {n} ranks"):
            port_sh._dp_tp_shape(n, shape, "ranks")


def test_group_layout_of_one_rank(tmp_path):
    """A process group of one rank: the default layout is (1, 1), a shape
    that does not hold it is refused before any subgroup is made, and the
    group form at world 1 equals the device-list form."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        world = dist.group.WORLD
        layout = port_sh.dp_tp_groups(group=world)
        assert layout.shape == (1, 1) and layout.position == (0, 0)
        assert layout.parent is world and dist.get_world_size(layout.model) == 1
        axes = port_sh._group_axes(world)
        assert axes.shape == (1, 1) and axes.model is world and axes.data is None
        assert port_sh._group_axes(layout) is layout
        assert port_sh._process_group(layout) is world
        for shape in ((2, 1), (1, 2)):
            with pytest.raises(ValueError, match="does not hold 1 ranks"):
                port_sh.dp_tp_groups(shape)
        table, cls, halo, sb = _table("packed")
        for form in (world, layout):
            for mode in MODES:
                got = port_sh._table_sharded_run(table, cls, halo, sb, None, CHUNK, mode,
                                                 group=form, device="cpu")
                want = port_sh._table_sharded_run(table, cls, halo, sb, [CPU], CHUNK, mode)
                assert (got == want if isinstance(want, int)
                        else torch.equal(got.view(torch.int32), want.view(torch.int32)))
        with pytest.raises(ValueError, match="not both"):
            port_sh._table_sharded_build(table, halo, sb, [CPU], "count", group=world)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_model", [1, 2, 3])
def test_states_past_the_last_shard_read_zero_on_every_rank(n_model):
    """State 5 of a 2-row table lies past the last shard: no rank owns it,
    every rank's word is 0, and the scan goes on from the root, as in the JAX
    body and the device-list form."""
    table = np.array([[5, 1], [0, 0]], dtype=np.uint32)
    w = torch.tensor([[0, 0, 0, 1]], dtype=torch.uint8)
    got = _simulated(table, w, 0, 3, (1, n_model), "raw")
    assert _np(got).tolist() == [[5, 0, 5, 0]]
    st = kernels.ShardedTable([s for _, s in _shards(table, n_model)])
    assert torch.equal(got.view(torch.int32),
                       kernels.table_sharded_scan(st, w, 0, 3, "raw").view(torch.int32))


@pytest.mark.parametrize("K", [1, 2, 4, 8, 16])
def test_ragged_last_segment(K, monkeypatch):
    """Bodies of 130 classes cut into K lanes of L = ceil(130 / K) (two of
    65 at K = 2; the last one shorter at K = 4 and 8, 31 and 11 positions;
    K = 16 gives 15 lanes of 9, the last of 4): the step loop counts and
    stores nothing past a window's body, uint8, uint16 and int32 windows
    alike, == the device-list form's twin (its own lanes, K <= 4, the caps
    patched) and the JAX 1-axis scan."""
    table, cls, halo, sb = _table("packed")
    windows = _windows(table, cls, halo, chunk=130)
    B, W = windows.shape
    for cap in ("MAX_LANES", "COUNT_MAX_LANES"):
        monkeypatch.setattr(scan_block, cap, B * min(K, 4))
    _force_k(monkeypatch, K)
    for mode in MODES:
        K_mesh, L_mesh = kernels.lane_segments(B, W - halo, halo, mode)
        assert K_mesh == min(K, 4)
        K_got, L = kernels.step_segments(B, W - halo, halo, mode)
        assert K_got == {16: 15}.get(K, K) and (K == 1 or (K_got - 1) * L < W - halo <= K_got * L)
        want = np.asarray(jax_sh._table_sharded_run(table, cls, halo, sb, _jmesh(), 130, mode))
        st = kernels.ShardedTable([s for _, s in _shards(table, 3)])
        plain = kernels.table_sharded_scan_plain(st, windows, halo, sb, mode)
        for dtype in (torch.uint8, torch.uint16, torch.int32):
            w = windows.to(torch.int32)
            w = w.to(torch.int16).view(torch.uint16) if dtype == torch.uint16 else w.to(dtype)
            got = _simulated(table, w, halo, sb, (1, 3), mode)
            if mode in ("count", "count_packed"):
                assert got == int(plain) == int(want) > 0
            else:
                assert tuple(got.shape) == (1, B * (W - halo))
                np.testing.assert_array_equal(_np(got), _np(plain))
                np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32],
                         ids=["uint8", "uint16", "int32"])
@pytest.mark.parametrize("K", [1, 2, 3, 8, 16, 32])
def test_step_classes_twin_equals_direct_indexing(K, dtype, monkeypatch):
    """The prep's twin (``step_classes``, CPU: ``step_classes_plain``):
    ``classes[t, b * K + k] == windows[b, k * L + t]`` where that lies in the
    row, else 0, for a ragged body of 101 (the last lane shorter) and a
    halo of 5; the values span the type (uint16 past 2**15, negative int32
    never: classes are not negative)."""
    rng = np.random.default_rng(K)
    B, halo, C = 7, 5, 101
    top = {torch.uint8: 256, torch.uint16: 1 << 16, torch.int32: 1 << 20}[dtype]
    host = rng.integers(0, top, size=(B, halo + C))
    w = torch.from_numpy(host.astype(np.int32))
    w = w.to(torch.int16).view(torch.uint16) if dtype == torch.uint16 else w.to(dtype)
    _force_k(monkeypatch, K)
    K_got, L = kernels.step_segments(B, C, halo, "planes")
    assert (K_got - 1) * L < C <= K_got * L and K_got <= K
    got = kernels.step_classes(w, halo, (K_got, L))
    assert got.dtype == dtype and tuple(got.shape) == (halo + L, B * K_got)
    assert torch.equal(got.view(kernels._signed(dtype)),
                       kernels.step_classes_plain(w, halo, (K_got, L)).view(kernels._signed(dtype)))
    want = np.zeros((halo + L, B * K_got), dtype=np.int64)
    for b in range(B):
        for k in range(K_got):
            for t in range(halo + L):
                if k * L + t < halo + C:
                    want[t, b * K_got + k] = host[b, k * L + t]
    np.testing.assert_array_equal(_np(got).astype(np.int64) & (top - 1 if top < 1 << 20 else -1),
                                  want)
    out = torch.empty_like(got)
    assert kernels.step_classes(w, halo, (K_got, L), out) is out and torch.equal(
        out.view(kernels._signed(dtype)), got.view(kernels._signed(dtype)))


def test_one_rank_model_axis_scans_in_one_launch(tmp_path, monkeypatch):
    """A model axis of one rank (gloo world 1 here): the rank holds the whole
    table and scans with ``table_sharded_scan`` (its twin on CPU ranks), in
    every mode, never the step loop; == the device-list form."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        calls = []

        def never(*args, **kwargs):
            raise AssertionError("group_scan at a one-rank model axis")

        def spy(table, *args):
            calls.append(table.n_model)
            return plain(table, *args)

        plain = kernels.table_sharded_scan_plain
        monkeypatch.setattr(kernels, "group_scan", never)
        monkeypatch.setattr(kernels, "table_sharded_scan_plain", spy)
        table, cls, halo, sb = _table("count_packed")
        for form in (dist.group.WORLD, port_sh.dp_tp_groups((1, 1))):
            for mode in MODES:
                got = port_sh._table_sharded_run(table, cls, halo, sb, None, CHUNK, mode,
                                                 group=form, device="cpu")
                want = port_sh._table_sharded_run(table, cls, halo, sb, [CPU], CHUNK, mode)
                assert (got == want if isinstance(want, int)
                        else torch.equal(got.view(torch.int32), want.view(torch.int32)))
        assert calls == [1] * 20  # the group form's and the device-list form's, every mode
    finally:
        dist.destroy_process_group()


def test_step_graphs_leave_cpu_windows_eager():
    """``group_scan`` with a ``StepGraphs`` on CPU windows runs the eager
    loop (graphs are CUDA's) and captures nothing."""
    table, cls, halo, sb = _table("packed")
    windows = _windows(table, cls, halo)
    graphs = kernels.StepGraphs()
    ranks = _shards(table, 2)
    for mode in ("count", "planes"):
        got = kernels.group_scan(ranks, windows, halo, sb, mode, _sum_ranks, graphs)
        want = kernels.group_scan(ranks, windows, halo, sb, mode, _sum_ranks)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)) if g.dim() else g == w
    assert len(graphs) == 0


def test_step_wrapper_refuses_bad_buffers():
    table, cls, halo, sb = _table("packed")
    windows = _windows(table, cls, halo)
    B, W = windows.shape
    C = W - halo
    (k, shard), = _shards(table, 1)
    K, L = kernels.step_segments(B, C, halo, "planes")
    classes = kernels.step_classes(windows, halo, (K, L))
    words = torch.zeros(B * K, dtype=torch.uint32)
    plane = torch.empty((1, B * C), dtype=torch.uint32)
    step = functools.partial(kernels.table_sharded_step, shard, k, words, classes)
    with pytest.raises(ValueError, match="not in 0 .. halo"):
        step(halo + L + 1, halo, sb, "planes", (K, L), C, plane)
    # Splits step_segments would not make: L off ceil(C / K), more than 32
    # lanes, a split without a halo to warm over, an empty last lane.
    for bad, h in (((K, L + 1), halo), ((33, -(-C // 33)), halo), ((2, C // 2), 0),
                   ((2, C), halo)):
        assert not kernels.valid_step_segments(bad, C, h)
        with pytest.raises(ValueError, match="do not cut"):
            kernels.table_sharded_step(shard, k, words, classes, 0, h, sb, "planes", bad, C,
                                       plane)
        with pytest.raises(ValueError, match="do not cut"):
            kernels.step_classes(windows[:, halo - h:].contiguous(), h, bad)
    with pytest.raises(ValueError, match="steps, not halo"):
        kernels.table_sharded_step(shard, k, words, classes[1:], 0, halo, sb, "planes", (K, L),
                                   C, plane)
    with pytest.raises(TypeError, match="total must be"):
        step(0, halo, sb, "count", (K, L), C, torch.zeros(B * K, dtype=torch.int64))
    with pytest.raises(TypeError, match="words must be"):
        kernels.table_sharded_step(shard, k, words[1:], classes, 0, halo, sb, "planes", (K, L),
                                   C, plane)
    with pytest.raises(TypeError, match="the shard must be"):
        kernels.table_sharded_step(shard.view(torch.int32), k, words, classes, 0, halo, sb,
                                   "planes", (K, L), C, plane)
    with pytest.raises(TypeError, match="classes must be"):
        kernels.table_sharded_step(shard, k, words, classes.t(), 0, halo, sb, "planes", (K, L),
                                   C, plane)
    with pytest.raises(ValueError, match="unknown mode"):
        step(0, halo, sb, "states", (K, L), C, plane)
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.step_segments(B, C, halo, "states")
    with pytest.raises(TypeError, match="windows must be"):
        kernels.step_classes(windows.to(torch.int64), halo, (K, L))
