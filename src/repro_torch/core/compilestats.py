"""Compile-event counters: the serving path's compile budget, measured.

In the JAX package an event is one jit trace (one XLA compile).  Eager
PyTorch compiles nothing per shape; the port's only per-process compile is
a kernel library that :func:`repro_torch.kernels._build.lib` builds with
``nvcc`` or loads from the build directory, the first time a process
launches one of its kernels.  That call records one event named
``build.<library>``, so ``StoreStats.compile_events`` and
``EpochResult.compile_events`` count exactly that, and an admission
prewarm that loads every library a session launches leaves a tenant's
serving path at zero.

The JAX package's persistent XLA cache (``enable_persistent_cache``,
``persistent_hits``, ``cache_dir``, ``REPRO_COMPILE_CACHE``) has no
counterpart: the build directory (``_build.build_dir()``) is the port's
persistent cache, and a library found there up to date is loaded, not
rebuilt.
"""
from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}


def record(name: str) -> None:
    """Count one compile event at site ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def counts() -> Dict[str, int]:
    """Per-site compile-event counts (copy)."""
    with _LOCK:
        return dict(_COUNTS)


def total() -> int:
    """Total compile events since process start (or :func:`reset`)."""
    with _LOCK:
        return sum(_COUNTS.values())


def snapshot() -> int:
    """Alias of :func:`total` — pair with :func:`since` around a region."""
    return total()


def since(snap: int) -> int:
    """Compile events recorded after a :func:`snapshot`."""
    return total() - snap


def reset() -> None:
    with _LOCK:
        _COUNTS.clear()
