"""The port's launch glue (``parallel/launch.py``) on CPU devices: the cases
of ``tests/test_launch.py``, and ``prepare_process_local`` + ``count`` against
the JAX package's count on the same classes.  True multi-process behaviour is
driven under gloo in ``tests/test_torch_sharding_dist.py``."""

import numpy as np
import pytest
import torch

import jax

import ahocorasick_tpu as act
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.parallel import launch as jax_launch
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch.parallel import launch, sharding

CPU = torch.device("cpu")
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_initialize_noop_single_process(monkeypatch):
    import torch.distributed as dist

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize() is False
    assert launch.initialize() is False  # idempotent
    assert launch.initialize(num_processes=1) is False  # one process is no job
    assert not dist.is_initialized()  # no backend was touched


def test_initialize_explicit_arguments_and_environment(monkeypatch, tmp_path):
    """A world of one under gloo from explicit arguments (a file store: no
    port is opened), then from the launcher's environment; twice is safe."""
    import torch.distributed as dist

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    try:
        assert launch.initialize(f"file://{tmp_path / 'store'}", num_processes=1, process_id=0,
                                 backend="gloo") is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert launch.initialize() is True  # already up
        assert launch.initialize("file:///nowhere", 1, 0) is True  # does not init again
        m = port.AhoCorasickSet(["ab", "bca", "cc"], engine="device", device="cpu")
        cls = m._classes("abcabcca " * 100)
        shards, offset = launch.prepare_process_local(
            cls, None, 1024, num_classes=m.compiled.num_classes, group=dist.group.WORLD,
            device="cpu")
        _, count, _ = sharding.make_sharded_counter(m, group=dist.group.WORLD)
        assert offset == 0 and list(shards) == [0] and count(shards) == m.count("abcabcca " * 100)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # Environment only, with an explicit argument missing: the address is required.
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert launch.initialize() is False  # MASTER_ADDR is not set: not a job
    with pytest.raises(ValueError, match="coordinator address"):
        launch.initialize(process_id=0)


def test_global_mesh_covers_all_devices():
    mesh = launch.global_data_mesh([CPU] * 8)
    assert mesh == [CPU] * 8 == sharding.data_mesh(["cpu"] * 8)
    assert len(mesh) == jax_launch.global_data_mesh().devices.size == len(jax.devices())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.global_data_mesh()


@pytest.mark.parametrize("world", [8, 3])
def test_prepare_process_local_feeds_sharded_counter(world):
    rng = np.random.default_rng(5)
    kws = ["ab", "bca", "cc"]
    jm = act.AhoCorasickSet(kws, engine="device")
    pm = port.AhoCorasickSet(kws, engine="device", device="cpu")
    text = "".join(rng.choice(list("abc "), size=9000))
    cls = pm._classes(text)
    np.testing.assert_array_equal(cls, jm._classes(text))

    mesh = launch.global_data_mesh([CPU] * world)
    prepare, count, _ = sharding.make_sharded_counter(pm, mesh)
    want = count(prepare(cls))

    local_units = 512 * world * (3 if world == 8 else 6)  # chunk x devices x k >= 9000
    shards, offset = launch.prepare_process_local(
        cls, mesh, local_units, num_classes=pm.compiled.num_classes)
    assert offset == 0
    assert sorted(shards) == list(range(world))
    assert sum(t.shape[0] for t in shards.values()) == local_units
    assert all(t.dtype == torch.uint8 for t in shards.values())
    assert count(shards) == want == len(pm.match(text))

    # The JAX package on the same classes: its launch glue and its counter.
    jmesh = jax_launch.global_data_mesh()
    jprepare, jcount, _ = jax_sh.make_sharded_counter(jm, jmesh)
    arr, joffset = jax_launch.prepare_process_local(cls, jmesh, 512 * 8 * 3)
    assert joffset == offset and int(jcount(arr)) == int(jcount(jprepare(cls))) == want


def test_prepare_process_local_validates():
    mesh = launch.global_data_mesh([CPU] * 8)
    with pytest.raises(ValueError, match="multiple"):
        launch.prepare_process_local(np.zeros(10, np.int32), mesh, 1000, num_classes=4)
    with pytest.raises(ValueError, match="longer"):
        launch.prepare_process_local(np.zeros(513 * 8 * 512, np.int32), mesh, 512 * 8,
                                     num_classes=4)
    with pytest.raises(ValueError, match="not both"):
        launch.prepare_process_local(np.zeros(10, np.int32), mesh, 512 * 8, num_classes=4,
                                     group=object(), device="cpu")
