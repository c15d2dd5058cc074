"""The port's randomized differential soak (``ahocorasick_tpu_torch.soak``) on
the CPU: seeded trials on the kernels' twins against gold, with and without
the sharded scanners and with the long-text axis forced; a ``check=`` hook
that holds the port's outputs against the JAX package's ``engine="device"``
matchers on the same repro; the shared draws against ``tools/soak.py``'s
(whose matchers are replaced by recorders, so only its draws run); and a
planted fault that must raise with a self-contained repro."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from ahocorasick_tpu_torch import soak
from ahocorasick_tpu_torch.models import matchers as M

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,trials,mesh_every", [(0, 6, 0), (1, 6, 0), (5, 6, 2),
                                                    (6, 6, 2), (4, 4, 1)])
def test_seeded_trials_equal_gold(seed, trials, mesh_every):
    res = soak.soak(seed, trials=trials, mesh_every=mesh_every, device="cpu")
    assert res["trials"] == trials and 0 < res["checked"] <= trials
    assert res["launches"] == {}  # CPU tensors take the twins, which launch nothing


def test_long_tails_stream_across_the_device_threshold(monkeypatch):
    from ahocorasick_tpu_torch.core import stream

    monkeypatch.setattr(soak, "LONG_SHARE", 1.0)
    rng = np.random.default_rng(5)
    longs = []
    for trial in range(4):
        repro = soak.run_trial(rng, trial, False, seed=5, device="cpu", max_units=24_000)
        if repro is not None and repro["tail"]:
            assert soak.LONG_MIN <= repro["tail"] <= len(repro["text"]) <= 24_000
            assert soak.LONG_FEED[0] <= repro["feed"] < soak.LONG_FEED[1]
            longs.append(repro["feed"])
    assert longs, "no trial drew a long tail"
    assert soak.LONG_FEED[0] < stream._STREAM_DEVICE_MIN < soak.LONG_FEED[1]


def test_port_axes_are_seeded_by_seed_and_trial():
    a = soak.port_axes(7, 3, list("ab"), 100)
    assert a == soak.port_axes(7, 3, list("ab"), 100)
    engines = {soak.port_axes(7, t, list("ab"), 100)["device_engine"] for t in range(40)}
    assert engines == set(M.AhoCorasickSet._DEVICE_ENGINES)
    assert soak.port_axes(7, 3, list("ab"), 0)["tail"] == ""  # no tail on an empty text
    assert all(soak.port_axes(s, t, list("ab"), 10, max_units=10 + soak.LONG_MIN - 1)["tail"]
               == "" for s in range(3) for t in range(30))


def _jax_set_engine(j, name):
    target = getattr(j, "_ac", None) if j.kind == "shortest" else j
    if target is not None and hasattr(type(target), "device_engine"):
        target.device_engine = name


def _jax_check(seen):
    """``check=``: the JAX package's ``engine="device"`` set and map matchers
    on the repro, against the port's device, count and map outputs."""
    import ahocorasick_tpu as J

    def check(repro, outputs):
        kws, cs, text = repro["kws"], repro["cs"], repro["text"]
        j = getattr(J, repro["cls"])(kws, cs, engine="device")
        _jax_set_engine(j, repro["device_engine"])
        assert j.match(text) == outputs["device"] == outputs["gold"], "device"
        assert j.count(text) == outputs["count"], "count"
        jm = getattr(J, repro["cls"].replace("Set", "Map"))(
            kws, [f"v{i}" for i in range(len(kws))], cs, engine="device")
        _jax_set_engine(jm, repro["device_engine"])
        assert jm.match(text) == outputs["map"], "map"
        seen.append(repro["cls"])

    return check


@pytest.mark.parametrize("seed", [11, 12])
def test_port_equals_the_jax_package_on_the_same_repro(seed):
    seen = []
    res = soak.soak(seed, trials=2, device="cpu", check=_jax_check(seen))
    assert len(seen) == res["checked"] > 0


def test_a_failing_check_raises_with_the_repro():
    def check(repro, outputs):
        assert False, "planted"

    with pytest.raises(soak.SoakMismatch) as err:
        soak.run_trial(np.random.default_rng(0), 0, False, device="cpu", check=check)
    assert "planted" in err.value.what and err.value.repro["kws"]


def _tools_soak():
    spec = importlib.util.spec_from_file_location("_tools_soak", ROOT / "tools" / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorders(classes, log):
    """Stand-ins for ``tools/soak.py``'s matcher classes: the gold matcher's
    ``match`` records the trial's class, case flag, keywords and text, the
    stream its chunk; every output is empty, so every check passes and only
    the draws run."""
    pairs = []
    for real_set, _ in classes:
        class Rec:
            kind = real_set.kind

            def __init__(self, kws, cs, engine="auto"):
                self.kws, self.cs, self.engine, self.compiled = kws, cs, engine, (kws, cs)

            @classmethod
            def from_compiled(cls, compiled, engine="auto"):
                return cls(*compiled, engine=engine)

            def match(self, text):
                if self.engine == "gold":
                    log.append({"cls": type(self).__name__, "cs": self.cs,
                                "kws": list(self.kws), "text": text})
                return []

            def count(self, text):
                return 0

            def match_stream(self, source, chunk_units):
                log[-1]["chunk"] = chunk_units
                return []

        Rec.__name__ = real_set.__name__

        class RecMap(Rec):
            def __init__(self, kws, vals, cs, engine="auto"):
                super().__init__(kws, cs, engine)

        pairs.append((Rec, RecMap))
    return pairs


@pytest.mark.parametrize("seed", [0, 777])
def test_shared_draws_equal_tools_soak(seed, monkeypatch):
    tools = _tools_soak()
    log = []
    monkeypatch.setattr(tools, "CLASSES", _recorders(tools.CLASSES, log))
    assert tools.ALPHABETS == soak.ALPHABETS
    assert [c.__name__ for c, _ in tools.CLASSES] == [c.__name__ for c, _ in soak.CLASSES]
    rng_tools, rng_port = np.random.default_rng(seed), np.random.default_rng(seed)
    rolled = 0
    for trial in range(12):
        before = len(log)
        tools.run_trial(rng_tools, trial, False)
        repro = soak.draw(rng_port, trial, seed=seed)
        assert (repro is None) == (len(log) == before), trial
        if repro is None:
            continue
        shared = repro["text"][: len(repro["text"]) - repro["tail"]]
        got = {"cls": repro["cls"], "cs": repro["cs"], "kws": repro["kws"], "text": shared,
               "chunk": repro["chunk"]}
        assert got == log[-1], trial
        rolled += 1
    assert rolled >= 6
    # The generators stay in step past the trials compared.
    assert rng_tools.integers(1 << 30) == rng_port.integers(1 << 30)


def test_a_dropped_triple_raises_with_a_self_contained_repro(monkeypatch):
    real = M._Matcher.match

    def drop_one(self, haystack, listener=None):
        out = real(self, haystack, listener)
        return out[:-1] if self.engine == "device" and out else out

    monkeypatch.setattr(M._Matcher, "match", drop_one)
    rng = np.random.default_rng(3)
    with pytest.raises(soak.SoakMismatch) as err:
        for trial in range(30):
            soak.run_trial(rng, trial, False, seed=3, device="cpu")
    repro = err.value.repro
    assert err.value.what == "device" and repro["kws"] and repro["text"]
    # The repro alone rebuilds the trial: the gold matcher finds the triple
    # that the planted fault dropped.
    monkeypatch.setattr(M._Matcher, "match", real)
    set_cls = getattr(M, repro["cls"])
    want = set_cls(repro["kws"], repro["cs"], engine="gold", device="cpu").match(repro["text"])
    dev = set_cls(repro["kws"], repro["cs"], engine="device", device="cpu")
    soak._set_engine(dev, repro["device_engine"])
    assert want and dev.match(repro["text"]) == want
    assert json.loads(json.dumps(repro)) == repro


def test_command_line(monkeypatch, capsys):
    assert soak.main(["--trials", "2", "--device", "cpu", "--seed", "9"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("soak clean: 2 trials") and out[-2].startswith("launches {")

    real = M._Matcher.match
    monkeypatch.setattr(M._Matcher, "match", lambda self, h, listener=None: (
        real(self, h, listener)[:-1] if self.engine == "device" else real(self, h, listener)))
    assert soak.main(["--trials", "30", "--device", "cpu", "--seed", "3"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("soak MISMATCH (device)")
    repro = json.loads(out[-1][len("repro: "):])
    assert repro["kws"] and repro["text"] and repro["seed"] == 3


def test_cuda_is_the_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(M.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.soak(0, trials=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.main(["--trials", "1"])
    with pytest.raises(ValueError, match="trials or minutes"):
        soak.soak(0, device="cpu")

