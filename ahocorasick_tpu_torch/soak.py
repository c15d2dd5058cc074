"""Randomized differential soak of the port: its device engines against the
gold model — the port of ``tools/soak.py``.

Rolls random dictionaries (seven alphabets, 1 to 59 keywords of up to 4, 8
or 40 units: packed-inline overflow included), random texts and every
matcher class, and checks ``engine="device"`` ``match``, ``from_compiled(...,
engine="auto")``, ``count``, the map class and ``match_stream``, and under
``--mesh`` the data-parallel ``ShardedScanner`` on eight shards of the one
device and, one trial in four, the ``TableShardedScanner`` on a 1-axis or 2-axis
mesh of eight, against the sequential gold model.  The draws of
``tools/soak.py`` are made from one generator in its order (dictionary, case
flag, class, text, stream chunk, the mesh draws), so trial n of seed s rolls
the same dictionary and text in both tools.  The port's own axes come from a
second generator seeded from ``(seed, trial)``: ``device_engine`` among the
names ``_DEVICE_ENGINES`` accepts, and now and then a long tail appended to
the text (tens to hundreds of Ki units, at most ``max_units`` in all) that is
streamed in feeds of 1-16 Ki units, either side of the stream cursor's
device threshold, by the device and the ``auto`` matchers.  A mismatch raises
``SoakMismatch`` with a self-contained repro dict; the command line prints it
and exits 1.  The launch counts (``kernels.build.launches``) over the run
show that the trials reached the kernels.

Run:  python -m ahocorasick_tpu_torch.soak [--minutes M | --trials N]
          [--seed S] [--mesh] [--device cuda|cpu] [--max-units U]

The default device is CUDA, and the command raises without it; ``--device
cpu`` runs the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.models import matchers as M
from ahocorasick_tpu_torch.utils import chartables

CLASSES = [
    (M.AhoCorasickSet, M.AhoCorasickMap),
    (M.LongestMatchSet, M.LongestMatchMap),
    (M.ShortestMatchSet, M.ShortestMatchMap),
    (M.WholeWordMatchSet, M.WholeWordMatchMap),
    (M.WholeWordLongestMatchSet, M.WholeWordLongestMatchMap),
]

# Uppercase variants included so cs=False trials exercise the case-folding
# charmap (lowercase-only alphabets make the folded and unfolded scans
# identical).
ALPHABETS = ["ab", "abc ", "abcdef -_.", "aàβ中 ", "a" * 1, "aAbB ", "àÀâ c"]

DEVICE_ENGINES = tuple(M.AhoCorasickSet._DEVICE_ENGINES)
MESH_SHARDS = 8  # one device named eight times: halos travel between shards
LONG_SHARE = 0.1  # of trials that append a long tail to the text
MAX_UNITS = 1 << 18  # the long texts' cap (code points of the tail and text)
LONG_MIN = 1 << 14
LONG_FEED = (1 << 10, 1 << 14)  # the long stream's feed sizes, either side of 4 Ki


class SoakMismatch(AssertionError):
    """An output of the port that differs from gold; ``repro`` rebuilds the
    trial (``kws``, ``text``, class, case flag and the port's axes)."""

    def __init__(self, what: str, repro: dict, *detail):
        super().__init__(what, repro, *detail)
        self.what = what
        self.repro = repro


def roll_dict(rng: np.random.Generator):
    alpha = list(ALPHABETS[int(rng.integers(len(ALPHABETS)))])
    n = int(rng.integers(1, 60))
    lo = 1
    hi = int(rng.choice([4, 8, 40]))  # 40 forces packed-inline overflow
    kws = set()
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        kws.add("".join(rng.choice(alpha, size=L)))
    return sorted(kws), alpha


def roll_text(rng, alpha):
    # Occasionally large enough to cross the auto-device thresholds.
    n = int(rng.integers(0, 40000 if rng.random() < 0.15 else 6000))
    return "".join(rng.choice(alpha + [" "], size=n))


def port_axes(seed: int, trial: int, alpha, n_text: int, max_units: int = MAX_UNITS) -> dict:
    """The port's own draws for trial ``trial`` of ``seed``, from a generator
    of their own so that the shared draws stay aligned: ``device_engine``,
    and a long ``tail`` (empty on most trials, and where the shared text is
    empty, so that the mesh draws stay aligned) with the feed size that
    streams it."""
    rng = np.random.default_rng([seed, trial])
    axes = {"device_engine": DEVICE_ENGINES[int(rng.integers(len(DEVICE_ENGINES)))],
            "tail": "", "feed": 0}
    room = max_units - n_text
    if rng.random() < LONG_SHARE and n_text and room >= LONG_MIN:
        n = int(rng.integers(LONG_MIN, room + 1))
        axes["tail"] = "".join(rng.choice(alpha + [" "], size=n))
        axes["feed"] = int(rng.integers(*LONG_FEED))
    return axes


def _set_engine(m, name: str) -> None:
    """``device_engine`` on ``m``, or on a Shortest matcher's internal AC;
    the whole-word-longest classes have no such knob."""
    target = m._ac if isinstance(m, M.ShortestMatchSet) else m
    if target is not None and hasattr(type(target), "_DEVICE_ENGINES"):
        target.device_engine = name


def _whole_word_keywords(set_cls, kws):
    """Whole-word keywords must survive trim; plain whole-word rejects
    interior non-word chars."""
    wc = chartables.default_word_chars()
    kept = []
    for k in kws:
        t = chartables.trim_word(k, wc)
        if not t:
            continue
        if set_cls.kind == "whole_word":
            u = chartables.to_utf16_units(t)
            if not np.all(wc[u]):
                continue
        kept.append(t)
    return sorted(set(kept))


def _pairs(trip):
    s, e = trip[0], trip[1]
    return list(zip(np.asarray(s).tolist(), np.asarray(e).tolist()))


def draw(rng, trial: int, *, seed: int = 0, max_units: int = MAX_UNITS) -> Optional[dict]:
    """The draws of one trial that precede its checks, in ``tools/soak.py``'s
    order (dictionary, case flag, class, text, stream chunk), and the port's
    axes: the trial's repro dict, or None where the drawn dictionary had no
    keyword left (its text and chunk are then not drawn, as there).  The
    checks draw nothing, so the mesh draws that follow them come next in
    both tools."""
    kws, alpha = roll_dict(rng)
    cs = bool(rng.integers(2))
    fam = int(rng.integers(len(CLASSES)))
    set_cls = CLASSES[fam][0]
    if set_cls.kind.startswith("whole_word"):
        kws = _whole_word_keywords(set_cls, kws)
    if not kws:
        return None
    text = roll_text(rng, alpha)
    chunk = int(rng.integers(1, 700))
    axes = port_axes(seed, trial, alpha, len(text), max_units)
    return {"seed": seed, "trial": trial, "cls": set_cls.__name__, "cs": cs, "kws": kws,
            "text": text + axes["tail"], "tail": len(axes["tail"]),
            "device_engine": axes["device_engine"], "chunk": chunk,
            "feed": axes["feed"] or chunk}


def run_trial(rng, trial: int, use_mesh: bool, *, seed: int = 0, device="cuda",
              max_units: int = MAX_UNITS, check: Optional[Callable] = None) -> Optional[dict]:
    """One trial, ``tools/soak.py``'s ``run_trial`` on the port.  Returns the
    repro dict (``draw``'s, with ``mesh`` and ``device``), or None where the
    drawn dictionary had no keyword left.  ``check(repro, outputs)``, if
    given, receives the trial's outputs after the port's own checks passed;
    an ``AssertionError`` it raises becomes a ``SoakMismatch``."""
    from ahocorasick_tpu_torch.parallel import sharding

    device = M._resolve_device(device)
    repro = draw(rng, trial, seed=seed, max_units=max_units)
    if repro is None:
        return None
    repro.update(mesh=use_mesh, device=str(device))
    set_cls, map_cls = next(c for c in CLASSES if c[0].__name__ == repro["cls"])
    kws, cs, full, feed = repro["kws"], repro["cs"], repro["text"], repro["feed"]
    engine = repro["device_engine"]

    def expect(what, ok, *detail):
        if not ok:
            raise SoakMismatch(what, repro, *detail)

    gold_m = set_cls(kws, cs, engine="gold", device=device)
    want = gold_m.match(full)

    dev = set_cls(kws, cs, engine="device", device=device)
    _set_engine(dev, engine)
    got = dev.match(full)
    expect("device", got == want, got[:5], want[:5])

    # The auto engine (the size thresholds) on the compiled tables: no third
    # host compile per trial.
    auto = set_cls.from_compiled(gold_m.compiled, engine="auto", device=device)
    _set_engine(auto, engine)
    got_a = auto.match(full)
    expect("auto", got_a == want, got_a[:5], want[:5])

    n = dev.count(full)
    expect("count", n == len(want), n, len(want))

    vals = [f"v{i}" for i in range(len(kws))]
    mm = map_cls(kws, vals, cs, engine="device", device=device)
    _set_engine(mm, engine)
    got_m = mm.match(full)
    expect("map", [(s, e) for s, e, _ in got_m] == want, got_m[:5], want[:5])

    got_s = dev.match_stream(io.StringIO(full), chunk_units=feed)
    expect("stream", got_s == want, feed)
    if repro["tail"]:
        got_as = auto.match_stream(io.StringIO(full), chunk_units=feed)
        expect("auto stream", got_as == want, feed)

    outputs = {"gold": want, "device": got, "auto": got_a, "count": n, "map": got_m,
               "stream": got_s}
    if use_mesh and len(full):
        # Every kind rides ShardedScanner (the whole-word boundary filter and
        # the WWL walks' restart-chain stitching included) on eight shards.
        mesh = [device] * MESH_SHARDS
        try:
            sc = sharding.ShardedScanner(dev, mesh)
        except ValueError:
            sc = None  # row-compressed shape without a sharded path
        if sc is not None:
            trip = sc.match_triples(full)
            expect("sharded", _pairs(trip) == want)
            nc = sc.count(full)
            expect("sharded-count", nc == len(want), nc, len(want))
            outputs["sharded"] = _pairs(trip)
            if rng.integers(4) == 0:
                # The table-sharded scan on a 1-axis or 2-axis (data x model)
                # mesh, with the host resolve, against the same gold.
                two = bool(rng.integers(2))
                layout = sharding.dp_tp_mesh(mesh) if two else sharding.model_mesh(mesh)
                try:
                    ts = sharding.TableShardedScanner(dev, layout)
                except ValueError:
                    ts = None  # unpackable shape: no state-sharded layout
                if ts is not None:
                    trip = ts.match_triples(full)
                    expect("table-sharded", _pairs(trip) == want,
                           "dp_tp_mesh" if two else "model_mesh")
                    outputs["table_sharded"] = _pairs(trip)
    if check is not None:
        try:
            check(repro, outputs)
        except SoakMismatch:
            raise
        except AssertionError as err:
            raise SoakMismatch(f"check: {err}", repro) from err
    return repro


def soak(seed: int = 0, *, trials: Optional[int] = None, minutes: Optional[float] = None,
         mesh_every: int = 0, device="cuda", check: Optional[Callable] = None,
         log=None) -> dict:
    """Trials of ``seed`` until ``trials`` ran or ``minutes`` passed (one of
    the two), the sharded scanners on every ``mesh_every``-th trial (0:
    never).  Returns ``{"trials", "checked", "long", "seconds",
    "launches"}``: the trials rolled, those that had keywords, those with a
    long tail, and the kernels' launch counts over the run.  Raises
    ``SoakMismatch`` at the first mismatch."""
    if (trials is None) == (minutes is None):
        raise ValueError("pass trials or minutes")
    device = M._resolve_device(device)
    rng = np.random.default_rng(seed)
    build.reset_launches()
    t0 = time.perf_counter()
    deadline = None if minutes is None else t0 + minutes * 60
    n = checked = long = 0
    while (n < trials) if trials is not None else (time.perf_counter() < deadline):
        use_mesh = bool(mesh_every) and n % mesh_every == 0
        repro = run_trial(rng, n, use_mesh, seed=seed, device=device, check=check)
        n += 1
        if repro is not None:
            checked += 1
            long += repro["tail"] > 0
        if log is not None and n % 50 == 0:
            print(f"{n} trials ok ({time.perf_counter() - t0:.1f} s)", file=log, flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"trials": n, "checked": checked, "long": long,
            "seconds": time.perf_counter() - t0,
            "launches": {k: v for k, v in build.launches.items() if v}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.soak",
                                description=__doc__.split("\n\n")[0])
    limit = p.add_mutually_exclusive_group()
    limit.add_argument("--minutes", type=float, default=None,
                       help="run for this long (default 10 without --trials)")
    limit.add_argument("--trials", type=int, default=None, help="run this many trials")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true",
                   help="also check the sharded scanners (slower per trial)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    minutes = 10.0 if args.minutes is None and args.trials is None else args.minutes
    try:
        res = soak(args.seed, trials=args.trials, minutes=minutes,
                   mesh_every=1 if args.mesh else 0, device=args.device, log=sys.stdout)
    except SoakMismatch as err:
        print(f"soak MISMATCH ({err.what}): {err.args[2:]}", flush=True)
        print("repro: " + json.dumps(err.repro, ensure_ascii=False), flush=True)
        return 1
    rate = res["trials"] / (res["seconds"] / 60)
    print(f"launches {json.dumps(res['launches'])}")
    print(f"soak clean: {res['trials']} trials ({res['checked']} with keywords, {res['long']} "
          f"with a long tail), seed {args.seed}, mesh {args.mesh}, device {args.device}, "
          f"{res['seconds']} s, {rate} trials a minute")
    return 0


if __name__ == "__main__":
    sys.exit(main())
