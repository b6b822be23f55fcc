"""Executable caches: the in-process LRU and JAX's persistent cache on disk.

The engine caches jitted programs by circuit structural key (interpreter.py,
api.py, density_circuit.py, dsl/backends.py). A long-lived service sweeping
many circuit structures must not grow those caches without bound, so every
executable cache is a :class:`BoundedCache`: least-recently-used entries are
evicted past ``maxsize`` (overridable via ``ROCQ_EXEC_CACHE_SIZE``).
Evicting a live executable is safe — the next use recompiles (and usually
rehits jax's own persistent compilation cache on disk, see
:func:`enable_compilation_cache`).
"""

from __future__ import annotations

import os
from collections import OrderedDict

_DEFAULT_SIZE = 256

# The persistent cache's key includes its path, so it lives at one fixed
# place inside the checkout (listed in .gitignore).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here; otherwise the cache goes to the fixed
    ``<repo>/.jax_cache``."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def _default_size() -> int:
    try:
        return max(1, int(os.environ.get("ROCQ_EXEC_CACHE_SIZE",
                                         _DEFAULT_SIZE)))
    except ValueError:
        return _DEFAULT_SIZE


class BoundedCache:
    """Dict-like LRU cache: reads refresh recency, inserts evict the oldest
    entry once ``maxsize`` is exceeded."""

    def __init__(self, maxsize: int = None):
        self._maxsize = maxsize
        self._data: OrderedDict = OrderedDict()

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None else _default_size()

    def get(self, key, default=None):
        try:
            self._data.move_to_end(key)
        except KeyError:
            return default
        return self._data[key]

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        self._data.move_to_end(key)
        return self._data[key]

    def __setitem__(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()
