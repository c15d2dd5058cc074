"""Native (C++) runtime helpers: resolver chain-following, bulk trie build.

Loaded lazily; every entry point has a pure-Python fallback so the package
works without the compiled extension (see ``lib.py``).
"""
