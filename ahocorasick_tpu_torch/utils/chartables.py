"""Java-parity character tables over the UTF-16 BMP (the port's copy of
``ahocorasick_tpu/utils/chartables.py``, with its own copy of the fixture).

The reference library operates on Java ``char`` values (UTF-16 code units) and
uses two JVM character predicates in its semantics:

* ``Character.toLowerCase(char)`` — per-code-unit simple lowercase mapping,
  locale independent (reference: ``AhoCorasickSet.java:33,229``).
* ``Character.isLetterOrDigit(char)`` — Unicode categories L* and Nd
  (reference: ``WordCharacters.java:6-16``).

We reproduce both as dense numpy tables of size 65536 so that every engine
(host gold model, CUDA kernels and their plain twins) folds characters identically.

Fidelity notes
--------------
* Both tables load from a COMMITTED FIXTURE
  (``utils/data/chartables_bmp.npz``), generated once and pinned by
  SHA-256 in ``tests/test_chartables.py`` — the semantics are data, not a
  function of whatever Unicode version the running CPython ships.
  ``tests/test_chartables.py`` also regenerates the fixture from CPython's
  ``unicodedata`` + the patch list below and asserts equality, so a future
  CPython/Unicode bump is surfaced as a test failure (a deliberate
  decision point), never a silent semantic change.
* Python's ``str.lower()`` implements the *full* case mapping; Java uses
  the *simple* one.  Over the BMP they differ only at U+0130 (LATIN
  CAPITAL LETTER I WITH DOT ABOVE), whose full mapping is two code points
  but whose simple (Java) mapping is ``U+0069 'i'`` — patched explicitly.
* The fixture encodes Unicode 15.0 (CPython 3.12), which matches modern
  JVMs (Java 20+ ships 15.0).  The reference targets Java 7 = Unicode
  6.0; code points assigned or case-changed between 6.0 and 15.0 diverge.
  The exact 6.0 delta is not enumerated (CPython bundles only 15.0 and
  3.2 — neither brackets 6.0 from the right side); the divergence is therefore
  documented as: "Character tables match a modern JVM, not Java 7, for
  code points whose properties changed after Unicode 6.0".  Behavior on
  every character the reference's own test corpus exercises is identical
  (those are all long-stable code points).
"""

from __future__ import annotations

import functools
import os
import unicodedata

import numpy as np

BMP = 65536

_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "chartables_bmp.npz")

# Java's simple lowercase mapping diverges from Python str.lower() here.
_SIMPLE_LOWER_PATCHES = {
    0x0130: 0x0069,  # İ -> i (full mapping is "i̇"; Java uses simple)
}


@functools.lru_cache(maxsize=1)
def _fixture():
    return np.load(_FIXTURE)


@functools.lru_cache(maxsize=1)
def lower_table() -> np.ndarray:
    """uint16[65536]: Java ``Character.toLowerCase`` per UTF-16 code unit.

    Loaded from the committed fixture (module docstring); regeneration
    logic lives in ``compute_lower_table``.
    """
    return _fixture()["lower"]


@functools.lru_cache(maxsize=1)
def letter_or_digit_table() -> np.ndarray:
    """bool[65536]: Java ``Character.isLetterOrDigit`` per UTF-16 unit.

    Loaded from the committed fixture (module docstring); regeneration
    logic lives in ``compute_letter_or_digit_table``.
    """
    return _fixture()["letter_or_digit"]


def compute_lower_table() -> np.ndarray:
    """Regenerate the simple-lowercase table from the running CPython's
    Unicode data + the simple-mapping patches (fixture generator; the
    fixture-equality test keeps this and the data in lockstep)."""
    tab = np.arange(BMP, dtype=np.uint32)
    for cp in range(BMP):
        low = chr(cp).lower()
        if len(low) == 1:
            lcp = ord(low)
            if lcp < BMP:
                tab[cp] = lcp
    for cp, lcp in _SIMPLE_LOWER_PATCHES.items():
        tab[cp] = lcp
    return tab.astype(np.uint16)


def compute_letter_or_digit_table() -> np.ndarray:
    """Regenerate the L*/Nd category table (fixture generator)."""
    cats = ("Lu", "Ll", "Lt", "Lm", "Lo", "Nd")
    tab = np.zeros(BMP, dtype=bool)
    for cp in range(BMP):
        if unicodedata.category(chr(cp)) in cats:
            tab[cp] = True
    return tab


def default_word_chars() -> np.ndarray:
    """bool[65536]: the reference's default word-character set.

    Letters, digits, ``-`` and ``_`` (reference ``WordCharacters.java:6-16``).
    Returns a fresh copy; callers may mutate.
    """
    tab = letter_or_digit_table().copy()
    tab[ord("-")] = True
    tab[ord("_")] = True
    return tab


def word_chars_from_list(word_characters) -> np.ndarray:
    """bool[65536] with exactly the given characters marked as word chars.

    Mirrors ``WordCharacters.generateWordCharsFlags(char[])`` (:18-24).
    """
    tab = np.zeros(BMP, dtype=bool)
    for ch in word_characters:
        tab[ord(ch)] = True
    return tab


def word_chars_with_toggles(word_characters, toggle_flags) -> np.ndarray:
    """Default set modified per (char, flag) pairs.

    Mirrors ``WordCharacters.generateWordCharsFlags(char[], boolean[])``
    (:26-39).
    """
    if len(word_characters) != len(toggle_flags):
        raise ValueError("word_characters and toggle_flags length mismatch")
    tab = default_word_chars()
    for ch, flag in zip(word_characters, toggle_flags):
        tab[ord(ch)] = bool(flag)
    return tab


def trim_word(keyword: str, word_chars: np.ndarray) -> str:
    """Strip non-word characters from both ends of ``keyword``.

    Mirrors ``WordCharacters.trim`` (:41-62) over UTF-16 units.  Note the
    Java loop quirk: if *no* word char exists, ``wordStart`` stays 0 and
    ``wordEnd`` stays ``len``, i.e. the keyword is returned unchanged; the
    caller then rejects/skips it on a per-char validation pass.
    """
    units = to_utf16_units(keyword)
    n = len(units)
    start, end = 0, n
    for i in range(n):
        if word_chars[units[i]]:
            start = i
            break
    for i in range(n - 1, -1, -1):
        if word_chars[units[i]]:
            end = i + 1
            break
    if start == 0 and end == n:
        return keyword
    return units_to_str(units[start:end])


def to_utf16_units(s: str) -> np.ndarray:
    """Encode a Python str as uint16 UTF-16 code units (Java String model).

    Positions reported by every matcher are indices into this array; for
    BMP-only text they coincide with Python string indices.
    """
    if not isinstance(s, str):
        raise TypeError(
            f"text must be str, got {type(s).__name__} — decode bytes before "
            "matching (the matcher operates on UTF-16 code units, Java parity)"
        )
    if not s:
        return np.zeros(0, dtype=np.uint16)
    return np.frombuffer(s.encode("utf-16-le"), dtype=np.uint16)


def units_to_str(units: np.ndarray) -> str:
    return np.asarray(units, dtype=np.uint16).tobytes().decode("utf-16-le", errors="surrogatepass")
