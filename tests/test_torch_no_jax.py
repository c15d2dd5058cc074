"""The port runs without JAX and without the JAX package: it imports neither
``jax`` nor anything of ``ahocorasick_tpu``."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Appended to every subprocess program: nothing of JAX or of the JAX package
# may have been loaded by then.
_CLEAN = (
    "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
    "             or k == 'ahocorasick_tpu' or k.startswith('ahocorasick_tpu.'))\n"
    "assert not bad, bad\n"
)


def test_port_imports_and_counts_without_loading_jax():
    code = (
        "import sys\n"
        "import ahocorasick_tpu_torch as P\n"
        "m = P.AhoCorasickSet(['he', 'she', 'hers'], engine='device', device='cpu')\n"
        "assert m.count('ushers and she') == 5, m.count('ushers and she')\n"
        "assert m.match('ushers') == [(1, 4), (2, 4), (2, 6)]\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_new_kinds_and_kernels_run_without_loading_jax():
    code = (
        "import io, sys\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch.kernels import build, compact, scan_dfa\n"
        "from ahocorasick_tpu_torch.ops import emit, scan_dfa as ops_scan_dfa\n"
        "from ahocorasick_tpu_torch.core.compiler import compile_matcher\n"
        "kw = dict(engine='device', device='cpu')\n"
        "t = 'ushers and she said hers'\n"
        "assert P.LongestMatchSet(['he', 'she', 'hers'], **kw).match(t) == [(1, 4), (11, 14), (20, 24)]\n"
        "assert P.WholeWordMatchSet(['she', 'hers'], **kw).match(t) == [(11, 14), (20, 24)]\n"
        "s = P.ShortestMatchMap(['he', 'she', 'hers'], [1, 2, 3], **kw)\n"
        "assert s.match(t) == [(1, 4, 2), (11, 14, 2), (20, 22, 1)], s.match(t)\n"
        "buf = io.BytesIO(); s.save(buf); buf.seek(0)\n"
        "assert P.load_matcher(buf, **kw).match(t) == s.match(t)\n"
        "c = compile_matcher(['he', 'she', 'hers'], 'shortest', True)\n"
        "f = P.ShortestMatchSet.from_compiled(c, **kw)\n"
        "assert f.match(t) == [(1, 4), (11, 14), (20, 22)], f.match(t)\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_whole_word_longest_runs_without_loading_jax():
    code = (
        "import io, sys\n"
        "import ahocorasick_tpu_torch as P\n"
        "kw = dict(engine='device', device='cpu')\n"
        "t = 'new york and york, new yorker at new  york'\n"
        "s = P.WholeWordLongestMatchSet(['new', 'york', 'yorker'], **kw)\n"
        "assert s.match(t) == [(0, 3), (4, 8), (13, 17), (19, 22), (23, 29), (33, 36), (38, 42)], s.match(t)\n"
        "m = P.WholeWordLongestMatchMap(['new york', 'new', 'york'], [1, 2, 3], **kw)\n"
        "assert m.match(t) == [(0, 8, 1), (13, 17, 3), (19, 22, 2), (33, 36, 2), (38, 42, 3)], m.match(t)\n"
        "buf = io.BytesIO(); m.save(buf); buf.seek(0)\n"
        "assert P.load_matcher(buf, **kw).match(t) == m.match(t)\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_huge_dictionary_layouts_run_without_loading_jax():
    code = (
        "import sys\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch.kernels import scan_batched\n"
        "from ahocorasick_tpu_torch.ops import dispatch\n"
        "deep = ['a' * i for i in range(1, 40)] + ['the']\n"
        "m = P.AhoCorasickSet(deep, engine='device', device='cpu')\n"
        "assert dispatch.planes_plan(m.compiled, m.dev).which == 'hotstate'\n"
        "assert m.count('aaaa the') == 11, m.count('aaaa the')\n"
        "assert m.match('aab the') == [(0, 1), (0, 2), (1, 2), (4, 7)], m.match('aab the')\n"
        "assert m.last_stats.engine == 'device'\n"
        "l = P.LongestMatchSet(deep, engine='device', device='cpu')\n"
        "assert l.match('aaaa the') == [(0, 4), (5, 8)], l.match('aaaa the')\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_streams_and_every_class_run_without_loading_jax():
    code = (
        "import io, sys\n"
        "import ahocorasick_tpu_torch as P\n"
        "t = 'ushers and she said hers at new york ' * 4\n"
        "kws = ['he', 'she', 'hers', 'new york', 'new']\n"
        "for engine in ('auto', 'device', 'gold'):\n"
        "    for name in P.__all__:\n"
        "        if not name.endswith(('Set', 'Map')):\n"
        "            continue\n"
        "        k = [w for w in kws if ' ' not in w] if name.startswith('WholeWordMatch') else kws\n"
        "        args = (k, list(range(len(k)))) if name.endswith('Map') else (k,)\n"
        "        m = getattr(P, name)(*args, engine=engine, device='cpu')\n"
        "        want = m.match(t)\n"
        "        assert want and m.match_stream(io.StringIO(t), chunk_units=7) == want, name\n"
        "        s = m.stream(); got = s.feed(t[:50], False); d = s.state_dict()\n"
        "        s2 = m.stream(); s2.load_state_dict(d)\n"
        "        assert got + s2.feed(t[50:], True) == want, name\n"
        "        seen = []\n"
        "        m.match(t, lambda *a: seen.append(a) or False)\n"
        "        assert len(seen) == 1\n"
        "        if m.is_map:\n"
        "            vals = []; m.match_readable(io.StringIO(t), vals.append)\n"
        "            assert vals == [v for _, _, v in want]\n"
        "        buf = io.BytesIO(); m.save(buf); buf.seek(0)\n"
        "        assert P.load_matcher(buf, engine=engine, device='cpu').match(t) == want\n"
        "from ahocorasick_tpu_torch.native import lib\n"
        "assert lib.available()\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_sharded_scanner_and_stitch_run_without_loading_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch import graft_entry\n"
        "from ahocorasick_tpu_torch.kernels import stitch as stitch_kernels\n"
        "from ahocorasick_tpu_torch.ops import scan_dfa, stitch\n"
        "from ahocorasick_tpu_torch.parallel import sharding\n"
        "from ahocorasick_tpu_torch.resolve import parallel\n"
        "mesh = [torch.device('cpu')] * 4\n"
        "t = 'ushers and she said hers ' * 50\n"
        "kw = dict(engine='device', device='cpu')\n"
        "m = P.AhoCorasickSet(['he', 'she', 'hers'], **kw)\n"
        "sc = sharding.ShardedScanner(m, mesh)\n"
        "assert sc.count(t) == m.count(t) == 350, sc.count(t)\n"
        "assert [x.tolist() for x in sc.match_triples(t)] == [x.tolist() for x in m.match_triples(t)]\n"
        "l = P.LongestMatchSet(['he', 'she', 'hers'], **kw)\n"
        "assert sharding.ShardedScanner(l, mesh).count(t) == len(l.match(t)) == 150\n"
        "w = P.WholeWordLongestMatchSet(['she said', 'she', 'hers'], **kw)\n"
        "assert sharding.ShardedScanner(w, mesh).count(t) == len(w.match(t)) == 100\n"
        "cls = torch.from_numpy(m._classes(t).astype('int32'))\n"
        "flat = scan_dfa.dfa_states(m.dev.dfa_next, cls)\n"
        "assert torch.equal(stitch.stitched_scan(m.dev.dfa_next, cls.reshape(50, 25)).reshape(-1), flat)\n"
        "assert (sharding.sharded_arrival_states(m.dev.dfa_next, m._classes(t), mesh) == flat.numpy()).all()\n"
        "graft_entry.dryrun_multigpu(4, mesh)\n"
        "fn, args = graft_entry.entry('cpu')\n"
        "assert fn(*args).dtype == torch.uint32\n"
        "assert P.__version__\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_sharding_dist as ranks\n"
        "assert ranks._run_cases(mesh=mesh)['arrival'].shape == (301,)\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_table_sharded_scanner_launch_and_corpus_run_without_loading_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch.kernels import table_sharded\n"
        "from ahocorasick_tpu_torch.ops import scan_batched\n"
        "from ahocorasick_tpu_torch.parallel import corpus, launch, sharding\n"
        "cpu = torch.device('cpu')\n"
        "t = 'ushers and she said hers at new york ' * 40\n"
        "kw = dict(engine='device', device='cpu')\n"
        "m = P.AhoCorasickSet(['he', 'she', 'hers'], **kw)\n"
        "for mesh in ([cpu] * 8, sharding.dp_tp_mesh([cpu] * 8), sharding.model_mesh(['cpu'] * 3)):\n"
        "    ts = sharding.TableShardedScanner(m, mesh)\n"
        "    assert ts.count(t) == m.count(t) == 280, ts.count(t)\n"
        "    assert [x.tolist() for x in ts.match_triples(t)] == [x.tolist() for x in m.match_triples(t)]\n"
        "    s, e, _ = ts.stream().feed(t, True)\n"
        "    assert list(zip(s.tolist(), e.tolist())) == m.match(t)\n"
        "pd = scan_batched.build_packed(m.compiled)\n"
        "assert sharding.sharded_table_count(pd.table, m._classes(t), pd.halo, pd.state_bits, [cpu] * 4) == 280\n"
        "for name in ('LongestMatchSet', 'ShortestMatchSet', 'WholeWordMatchSet', 'WholeWordLongestMatchSet'):\n"
        "    k = getattr(P, name)(['she', 'said', 'hers', 'new'], **kw)\n"
        "    s, e, _ = sharding.TableShardedScanner(k, [cpu] * 8).match_triples(t)\n"
        "    assert list(zip(s.tolist(), e.tolist())) == k.match(t), name\n"
        "deep = P.AhoCorasickSet(['a' * i for i in range(1, 40)] + ['the'], **kw)\n"
        "th = sharding.TableShardedScanner(deep, [cpu] * 8)\n"
        "assert th.layout == 'hotstate' and th.count('aaaa the') == 11\n"
        "assert launch.initialize() is False\n"
        "shards, off = launch.prepare_process_local(m._classes(t), [cpu] * 2, 2048, num_classes=m.compiled.num_classes)\n"
        "assert off == 0 and sharding.make_sharded_counter(m, [cpu] * 2)[1](shards) == 280\n"
        "res, stats = corpus.scan_corpus(m, [t, 'x', 'she'])\n"
        "assert res == [m.match(t), [], [(0, 3), (1, 3)]] and stats.documents == 3 and stats.matches == 282\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_bench_and_stride2_scan_run_without_loading_jax():
    code = (
        "import io, os, sys, tempfile, contextlib\n"
        "import numpy as np\n"
        "import torch\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch import bench\n"
        "from ahocorasick_tpu_torch.bench import __main__ as bench_main, headline\n"
        "from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow\n"
        "from ahocorasick_tpu_torch.ops import dispatch, scan_batched, scan_rowdfa\n"
        "from ahocorasick_tpu_torch.utils.stats import trace\n"
        "m = P.AhoCorasickSet(['he', 'she', 'hers'], engine='device', device='cpu')\n"
        "t = 'ushers and she said hers ' * 30\n"
        "rd = scan_rowdfa.build_rowdfa(m.compiled)\n"
        "assert rd.table.shape == (rd.table.shape[0], m.compiled.num_classes + 1)\n"
        "assert dispatch.planes_plan(m.compiled, m.dev).which == 'packed'\n"
        "m.device_engine = 'batched2'\n"
        "assert dispatch.planes_plan(m.compiled, m.dev, m._force()).which == 'rowdfa2'\n"
        "assert m.count(t) == 210 and m.match(t)[:3] == [(1, 4), (2, 4), (2, 6)]\n"
        "assert bench.ac_kernel_rate(m, m._classes(t), reps=1, min_units=1)[1:] == (210, 'rowdfa2')\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    with trace(d):\n"
        "        m.count(t)\n"
        "    assert [os.path.getsize(os.path.join(d, f)) > 0 for f in os.listdir(d)] == [True]\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    bench_main.main(['--platform', 'cpu', '--keywords', '20', '--units', '500', '--reps', '1'])\n"
        "    os.environ['BENCH_TEXT_UNITS'] = '4096'; os.environ['BENCH_BUDGET_S'] = '1'\n"
        "    headline.main('cpu')\n"
        "lines = out.getvalue().splitlines()\n"
        "assert len(lines) == 2 and '\"metric\": \"dfa_scan_throughput\"' in lines[1], lines\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_probes_and_pfac_walk_run_without_loading_jax():
    code = (
        "import contextlib, io, sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import ahocorasick_tpu_torch as P\n"
        "from ahocorasick_tpu_torch.kernels import probes as kp, scan_pfac as kpf\n"
        "from ahocorasick_tpu_torch.ops import emit, scan_pfac, scan_pfac2\n"
        "from ahocorasick_tpu_torch.probes import __main__ as probes_main, probe, probe6\n"
        "t = torch.tensor([1, 2, 3, 0], dtype=torch.int32)\n"
        "assert kp.chain_gather(t, torch.tensor([0], dtype=torch.int32), 5, 'load').tolist() == [1]\n"
        "assert probe.probe_lane_gather(reps=2, B=8, device='cpu')[1].shape == (8, 128)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    probes_main.main(['--platform', 'cpu', '--no-sweep'])\n"
        "m = P.AhoCorasickSet(['he', 'she', 'hers'], engine='device', device='cpu')\n"
        "t = 'ushers and she said hers ' * 30\n"
        "want = m.match(t)\n"
        "m.device_engine = 'pfac2'\n"
        "assert m.match(t) == want and m.count(t) == len(want) == 210\n"
        "rt = m.dev.ranked\n"
        "assert rt.trie_next.dtype == torch.uint32 and rt.prefix_k >= 1\n"
        "l = P.LongestMatchSet(['he', 'she', 'hers'], engine='device', device='cpu')\n"
        "l.device_engine = 'pfac2'\n"
        "assert l.match('ushers') == [(1, 4)]\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_last_probes_run_without_loading_jax():
    """probe4 to probe10_tp and their two kernels' wrappers, at small sizes
    on the CPU twins."""
    code = (
        "import contextlib, io, sys\n"
        "import torch\n"
        "from ahocorasick_tpu_torch.kernels import probes as kp\n"
        "from ahocorasick_tpu_torch.probes import __main__ as probes_main\n"
        "from ahocorasick_tpu_torch.probes import probe4, probe5, probe6, probe7\n"
        "from ahocorasick_tpu_torch.probes import probe8_minimize, probe9_scaling, probe10_tp\n"
        "t = torch.tensor([[1, 2], [0, 3]], dtype=torch.int32)\n"
        "s = torch.tensor([0, 1], dtype=torch.int32)\n"
        "c = torch.tensor([[1, 0]], dtype=torch.int32)\n"
        "assert kp.row_select(t, s, c, 1, 'select', 2).tolist() == [0, 0]\n"
        "assert kp.row_select(t, s, None, 1, 'sum', 2).tolist() == [1, 1]\n"
        "w = torch.tensor([[1, 1], [0, 1]], dtype=torch.uint8)\n"
        "assert int(kp.window_chain(t, w)) == 6\n"
        "probe7.B_LANES, probe7.CHUNK = 16, 64\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    probe4.main('cpu', small=True)\n"
        "    probe5.main('cpu', small=True)\n"
        "    probes_main.main(['--platform', 'cpu', '--widths'])\n"
        "    probe7.main(['--platform', 'cpu', '--part', 'ABC', '--mb', '1', '--rows', '512',\n"
        "                 '--crows', '256'])\n"
        "    assert probe8_minimize.run_config('5', 200)[0]['states'] > 200\n"
        "    o9 = probe9_scaling.main(['--platform', 'cpu', '--keywords', '50',\n"
        "                              '--units', '2048'])\n"
        "    o10 = probe10_tp.main('cpu', 50, 2048, min_units=0)\n"
        "assert o9['scan_count'] == o10['total'] > 0\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_soak_runs_as_a_command_without_loading_jax():
    code = (
        "import contextlib, io, runpy, sys\n"
        "sys.argv = ['soak', '--trials', '3', '--device', 'cpu', '--seed', '4', '--mesh']\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    try:\n"
        "        runpy.run_module('ahocorasick_tpu_torch.soak', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (e.code, out.getvalue())\n"
        "assert 'soak clean: 3 trials' in out.getvalue(), out.getvalue()\n"
        + _CLEAN
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|ahocorasick_tpu)(?![\w])", re.M)


def test_import_guard_pattern():
    for bad in ("import jax", "from jax import numpy", "  import jax.numpy as jnp",
                "import ahocorasick_tpu", "from ahocorasick_tpu.core import gold",
                "    from ahocorasick_tpu import chartables", "import ahocorasick_tpu.native.lib"):
        assert _IMPORT.search(bad), bad
    for good in ("import ahocorasick_tpu_torch", "from ahocorasick_tpu_torch.core import gold",
                 "# from ahocorasick_tpu import x", "import jaxtyping",
                 "the port of ``ahocorasick_tpu/ops/emit.py``"):
        assert not _IMPORT.search(good), good


def test_port_sources_never_import_jax():
    """Neither ``jax`` nor the JAX package, in the port, ``chip_smoke.py`` or
    the module of the spawned gloo ranks."""
    pattern = _IMPORT
    sources = sorted((ROOT / "ahocorasick_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    sources.append(ROOT / "tests" / "test_torch_sharding_dist.py")
    assert len(sources) > 8
    for name in ("parallel/sharding.py", "parallel/__init__.py", "ops/stitch.py",
                 "kernels/stitch.py", "resolve/parallel.py", "graft_entry.py",
                 "kernels/table_sharded.py", "parallel/launch.py", "parallel/corpus.py",
                 "bench/__init__.py", "bench/__main__.py", "bench/headline.py",
                 "ops/scan_rowdfa.py", "kernels/scan_rowdfa.py", "utils/stats.py",
                 "kernels/probes.py", "kernels/scan_pfac.py", "ops/scan_pfac.py",
                 "ops/scan_pfac2.py", "ops/emit.py", "probes/__init__.py", "probes/probe.py",
                 "probes/probe2.py", "probes/probe3.py", "probes/probe6.py",
                 "probes/probe4.py", "probes/probe5.py", "probes/probe7.py",
                 "probes/probe8_minimize.py", "probes/probe9_scaling.py",
                 "probes/probe10_tp.py", "probes/__main__.py", "soak.py"):
        assert ROOT / "ahocorasick_tpu_torch" / name in sources, name
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    # Nor the JAX probes of tools/probes/ (importable as top-level modules).
    tools = re.compile(r"^\s*(?:import|from)\s+(?:tools|probe\d*)(?![\w])", re.M)
    assert tools.search("import probe as jprobe") and tools.search("from tools.probes import x")
    assert [str(p) for p in sources if tools.search(p.read_text())] == []
