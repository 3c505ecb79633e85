"""Deterministic fault injection (DESIGN.md §10), the JAX package's
registry carried over as it is.

A process-wide registry of NAMED fault points wired into the durability
and epoch-commit call sites:

    store.commit.fold   before each committed-region fold of a commit
    store.normalize     before a batch normalize probe
    pool.prep           stage A of a pool epoch (host pack)
    pool.apply          stage B of a pool epoch (device apply)
    wal.append          before a WAL record write
    wal.fsync           before the WAL fsync
    snapshot.write      before a snapshot checkpoint write
    dist.program        before launching a distributed join program

In the port every point has a call site, placed where the JAX package
fires it (``core.delta.RegionStore``, ``serve.pool.SessionPool``,
``serve.wal``, ``core.distributed.run_program``), so one schedule faults
at the same hit in both packages.

Each call site calls :func:`fire(point)`; the registry counts the hit and
raises :class:`~repro_torch.errors.FaultInjected` when the hit number is in
the point's schedule.  Schedules come from the environment —

    REPRO_FAULTS="wal.fsync@7,store.commit.fold@12"

(fire on the 7th ``wal.fsync`` hit and the 12th ``store.commit.fold``
hit; ``point@3-5`` fires a range, ``point@*`` every hit) — or
programmatically via :func:`install`.  Hit counting is per-point,
process-wide and thread-safe; schedules are deterministic, so a run with
the same inputs injects the same faults (:func:`random_schedule` builds a
seeded random schedule that replays exactly).

:func:`disabled` suspends firing on the current thread — differential
oracles running in the same process as a chaos run use it so scheduled
faults only ever hit the system under test.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.errors import FaultInjected

ENV_VAR = "REPRO_FAULTS"
EVERY = -1  # sentinel hit number: fire on every hit

POINTS = (
    "store.commit.fold", "store.normalize", "pool.prep", "pool.apply",
    "wal.append", "wal.fsync", "snapshot.write", "dist.program",
)

_lock = threading.Lock()
_hits: Dict[str, int] = {}
_sched: Dict[str, Set[int]] = {}
_injected: List[Tuple[str, int]] = []
_env_loaded = False
_tl = threading.local()


def parse_spec(spec: str) -> Dict[str, Set[int]]:
    """Parse ``"wal.fsync@7,store.commit.fold@3-5,pool.apply@*"`` into
    ``{point: {hit numbers}}`` (1-based hits; ``EVERY`` for ``*``)."""
    out: Dict[str, Set[int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" in part:
            point, at = part.split("@", 1)
        else:
            point, at = part, "*"
        hits = out.setdefault(point.strip(), set())
        at = at.strip()
        if at == "*":
            hits.add(EVERY)
        elif "-" in at:
            lo, hi = at.split("-", 1)
            hits.update(range(int(lo), int(hi) + 1))
        else:
            hits.add(int(at))
    return out


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        for point, hits in parse_spec(spec).items():
            _sched.setdefault(point, set()).update(hits)


def install(schedule, *, reset_counts: bool = True) -> None:
    """Install a programmatic schedule: a spec string (see
    :func:`parse_spec`) or a ``{point: iterable-of-hit-numbers}`` dict.
    Replaces any existing schedule (env spec included)."""
    global _env_loaded
    if isinstance(schedule, str):
        schedule = parse_spec(schedule)
    with _lock:
        _env_loaded = True  # explicit install overrides the env spec
        _sched.clear()
        for point, hits in schedule.items():
            _sched[point] = {int(h) for h in hits}
        if reset_counts:
            _hits.clear()
            _injected.clear()


def clear() -> None:
    """Drop every schedule and counter (the env spec stays consumed)."""
    install({}, reset_counts=True)


def active() -> bool:
    """True when ANY fault point is armed.  Transactional code paths use
    this to prefer rollback-safe variants (e.g. the commit fold runs
    without buffer donation while faults are armed, so a mid-commit
    rollback never resurrects a donated buffer)."""
    with _lock:
        _load_env_locked()
        return bool(_sched)


def fire(point: str) -> None:
    """Count one hit of ``point``; raise FaultInjected when scheduled."""
    if getattr(_tl, "paused", 0):
        return
    with _lock:
        _load_env_locked()
        if not _sched:
            return
        n = _hits.get(point, 0) + 1
        _hits[point] = n
        hits = _sched.get(point)
        hit = hits is not None and (EVERY in hits or n in hits)
        if hit:
            _injected.append((point, n))
    if hit:
        raise FaultInjected(point, n)


class disabled:
    """Context manager: suspend fault firing on the current thread (hits
    are not counted either) — lets in-process differential oracles share a
    process with a chaos run."""

    def __enter__(self):
        _tl.paused = getattr(_tl, "paused", 0) + 1
        return self

    def __exit__(self, *exc):
        _tl.paused -= 1
        return False


def counts() -> Dict[str, int]:
    """Hit counters per point (introspection/accounting)."""
    with _lock:
        return dict(_hits)


def injected() -> List[Tuple[str, int]]:
    """Chronological ``(point, hit)`` list of faults actually raised."""
    with _lock:
        return list(_injected)


def random_schedule(seed: int, points: Optional[Iterable[str]] = None,
                    horizon: int = 200, rate: float = 0.05
                    ) -> Dict[str, Set[int]]:
    """A seeded random schedule: each of the first ``horizon`` hits of
    each point fires independently with probability ``rate``.  Pure
    function of its arguments — the chaos harness logs (seed, rate) and
    any run can be reproduced exactly."""
    import numpy as np
    rng = np.random.default_rng(int(seed) * 1_000_003 + 7)
    out: Dict[str, Set[int]] = {}
    for point in (POINTS if points is None else points):
        draws = rng.random(int(horizon)) < float(rate)
        hits = {int(i) + 1 for i in np.flatnonzero(draws)}
        if hits:
            out[point] = hits
    return out


__all__ = ["ENV_VAR", "EVERY", "POINTS", "parse_spec", "install", "clear",
           "active", "fire", "disabled", "counts", "injected",
           "random_schedule"]
