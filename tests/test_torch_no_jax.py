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
    """Neither ``jax`` nor the JAX package, in the port or ``chip_smoke.py``."""
    pattern = _IMPORT
    sources = sorted((ROOT / "ahocorasick_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 8
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
