"""Warn-once caches for the once-per-shape fallback warnings.

Each cache is a set of keys already warned about; ``reset_warning_caches``
clears them all so a test asserting a once-per-shape warning does not
depend on which test ran first.
"""
from __future__ import annotations

_CACHES: list = []


def warn_once_cache() -> set:
    cache: set = set()
    _CACHES.append(cache)
    return cache


def reset_warning_caches() -> None:
    for cache in _CACHES:
        cache.clear()
