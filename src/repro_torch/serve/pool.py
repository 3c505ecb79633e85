"""SessionPool: N tenants served from ONE device (or one mesh on it).

The serving layer above :mod:`repro_torch.api` (the JAX package's
``repro.serve.pool``, on one card): each tenant owns an independent
:class:`~repro_torch.api.GraphSession` — its own graph, standing queries
and epoch counter — and every session lives on the pool's device and
shares the process's kernel libraries, so N tenants pay one build of each.

Scheduling (DESIGN.md §9):

- **Bounded ingest + backpressure.**  Each tenant has its own bounded
  ingest queue.  ``submit`` on a full queue blocks that CALLER (or sheds
  the batch with ``block=False``) — a slow tenant backs up into its own
  queue and never stalls the device or another tenant.
- **Adaptive coalescing.**  The prep stage drains up to ``coalesce``
  queued batches per epoch (bounded by the tenant's ``update_batch``, the
  bound the admission prewarm pinned the probe and delta buffers to).
  For SIGN-CONSISTENT streams (every delete names a then-live tuple,
  every insert a then-absent one — ``data.synthetic.clean_update_batches``
  generates these) the merged epoch is exact: per-tuple net weight equals
  final-minus-initial membership.  Dirty streams that insert a live tuple
  in one batch and delete it in the next can net differently when merged
  (set semantics clamp the insert; the merged weights cancel instead) —
  tenants needing per-batch set semantics serve with ``coalesce=1``.
  Either way the WAL logs the MERGED batch the device actually applied,
  so recovery replay is always bit-exact with what was served.  All
  tickets of a group resolve to the shared EpochResult.
- **Pipelined epochs.**  A prep thread runs the pure-host stage A
  (``session.prepare``: validate/pack/pad in numpy, no device call) while
  the apply thread runs stage B (``update(prepared=...)``: normalize →
  dataflows → commit fold on the card) — batch k+1's host work overlaps
  batch k's device work.  Round-robin across tenants in both stages keeps
  admission fair.  The SINGLE apply thread issues every launch, under
  ``torch.cuda.device`` of the pool's device, on that thread's current
  (default) stream; snapshots on the cadence run there too.  That one
  launching thread is also what keeps ``kernels.LAUNCHES`` exact: its
  counters are unlocked increments.  A ticket hands a client the epoch's
  :class:`~repro_torch.api.session.EpochResult`, whose batches and deltas
  are host numpy arrays, so no device tensor reaches a client thread.
- **Durability.**  With ``durable_dir``, each tenant gets a
  :class:`~repro_torch.serve.wal.Durability` manager: WAL append before
  every apply, snapshot + WAL truncation on a cadence, recovery at
  admission (see ``wal.py`` for the bit-exact replay contract).

Admission prewarm: ``admit`` runs ``GraphSession.prewarm`` (marks pinned,
every kernel library of the session's path loaded) before the tenant
serves, so steady-state serving records ZERO compile events
(``ServeStats.serve_compiles``).  Admission, and the recovery replay in
it, runs on the caller's thread.

**On a mesh of ranks** (``mesh`` with ``ranks > 1``, from
``launch.mesh.init_rank_mesh``) every rank builds the pool with the same
arguments and admits the same tenants in the same order (admission, its
recovery included, is a collective, made while rank 0 does not serve).
Rank 0 is the ingress: ``submit`` works only there, and rank 0 alone
coalesces, prepares and schedules.  Before each apply its apply thread
broadcasts a schedule record (the tenant, the merged raw batch, whether
the WAL still takes it and whether a snapshot is due, the tenants
fenced off); the other ranks' apply loops receive it, ``prepare`` the
batch themselves and apply it, so every rank makes the same collectives
in the same order, and the apply thread (or the loop of ``drain``) is
the only one of a rank that makes one.  Rank 0 decides what only it
sees (a failed prep is never broadcast; WAL retries, degradation and
quarantine travel in the next record), every rank fires ``pool.apply``
and the store's and the mesh's fault points itself at the same hits,
and every rank checks that the ranks agree on each epoch's outcome.
Tickets resolve on rank 0.  A serving period runs from rank 0's first
submit to a ``drain``/``pump``/``close``, which every rank calls at the
same point of its program: rank 0's sends one stop record, and the
other ranks' follow the records until it.  Meanwhile an idle rank 0
sends an idle record every ``idle_s`` seconds (a quarter of the group's
timeout), so an idle pool never trips that timeout.
Collective reads of a session (``session.edges``, ``count()``) belong
between serving periods, on every rank in the same order.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core import compilestats
from repro_torch.core.csr import resolve_device
from repro_torch.errors import WalError
from repro_torch.serve.stats import ServeStats, TenantStats
from repro_torch.serve.wal import Durability


class Ticket:
    """One submitted batch's future result (thread-safe).

    Resolves to the :class:`~repro_torch.api.session.EpochResult` of the device
    epoch that carried the batch — shared by every batch coalesced into
    that epoch.  Exceptions from the epoch propagate out of
    :meth:`result`."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("epoch still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result=None, error=None):
        self._result = result
        self._error = error
        self._event.set()


class _Tenant:
    """Pool-internal per-tenant state (guarded by the pool's condition)."""

    def __init__(self, name: str, session, max_queue: int, coalesce: int,
                 durability: Optional[Durability]):
        self.name = name
        self.session = session
        self.max_queue = int(max_queue)
        self.coalesce = max(int(coalesce), 1)
        self.durability = durability
        # ingest: (batches_dict, ticket); prepared: one in-flight slot
        self.ingest = collections.deque()
        self.prepared = None  # (PreparedBatch, tickets, prep_ms)
        self.stats = TenantStats(name=name)
        # robustness (DESIGN.md §10): durable=False after WAL degrade;
        # consecutive_failures feeds the quarantine trip wire.
        self.durable = durability is not None
        self.consecutive_failures = 0
        self.quarantined = False


class TenantHandle:
    """Public face of one admitted tenant."""

    def __init__(self, pool: "SessionPool", name: str):
        self.pool = pool
        self.name = name

    @property
    def session(self):
        return self.pool._tenants[self.name].session

    @property
    def stats(self) -> TenantStats:
        return self.pool._tenants[self.name].stats

    @property
    def durability(self) -> Optional[Durability]:
        """The tenant's snapshot + WAL manager (None without
        ``durable_dir``)."""
        return self.pool._tenants[self.name].durability

    def submit(self, updates, weights=None, *, block: bool = True,
               timeout: Optional[float] = None) -> Optional[Ticket]:
        return self.pool.submit(self.name, updates, weights, block=block,
                                timeout=timeout)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"TenantHandle({self.name!r})"


class SessionPool:
    """Multiplex N tenant GraphSessions onto one device (module docstring).

    ``device=None`` means ``"cuda"`` and raises when CUDA is absent, as
    ``GraphSession`` does; pass ``device="cpu"`` to serve on the host.
    ``local``, ``mesh`` and ``balance`` choose every tenant's engine as
    ``GraphSession``'s do: ``local=False`` without a ``mesh`` builds one of
    ``launch.mesh.DEFAULT_WORKERS`` (4) workers on the pool's device, and
    every tenant's session is built on the pool's mesh.  On a mesh of
    ranks (module docstring) rank 0 sends an idle record after
    ``idle_s``, a quarter of the mesh's timeout, without one."""

    def __init__(self, *, device=None, local: Optional[bool] = None,
                 mesh=None, balance: bool = False, update_batch: int = 2048,
                 prewarm: bool = True, horizon: Optional[int] = None,
                 pipeline: bool = True, durable_dir: Optional[str] = None,
                 snapshot_every: int = 8, keep_last: int = 3,
                 fsync: bool = True,
                 on_logged: Optional[Callable[[str, int], None]] = None,
                 quarantine_after: int = 3, wal_retries: int = 3,
                 wal_backoff_s: float = 0.02):
        if local is None:
            local = mesh is None
        self.local = bool(local)
        if mesh is not None and not self.local and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if not self.local:
            from repro_torch.launch.mesh import (DEFAULT_WORKERS,
                                                 make_host_mesh)
            if mesh is None:
                mesh = make_host_mesh(DEFAULT_WORKERS, self.device)
            elif resolve_device(mesh.device) != self.device:
                raise ValueError(f"the mesh's device {mesh.device} is not "
                                 f"the pool's {self.device}")
        self.mesh = None if self.local else mesh
        # the mesh of ranks that every apply follows (None: one process)
        self._ranks = self.mesh if self.mesh is not None and \
            self.mesh.ranks > 1 else None
        self.root = self._ranks is None or self._ranks.rank == 0
        self.idle_s = self._ranks.timeout_s / 4 if self._ranks is not None \
            else 0.0
        self.balance = bool(balance)
        self.update_batch = int(update_batch)
        self.prewarm = bool(prewarm)
        self.horizon = horizon
        self.pipeline = bool(pipeline)
        self.durable_dir = durable_dir
        self.snapshot_every = int(snapshot_every)
        self.keep_last = int(keep_last)
        self.fsync = bool(fsync)
        self.on_logged = on_logged  # test hook: fires after WAL append
        # robustness knobs (DESIGN.md §10): a tenant whose epochs fail
        # ``quarantine_after`` times IN A ROW is fenced off (its queue
        # failed, new submits refused) so a poisoned stream can't spin
        # the shared apply thread forever; WAL appends retry
        # ``wal_retries`` times with linear backoff, then the tenant
        # LOUDLY degrades to non-durable serving rather than stalling.
        self.quarantine_after = int(quarantine_after)
        self.wal_retries = int(wal_retries)
        self.wal_backoff_s = float(wal_backoff_s)
        self._cv = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._names: List[str] = []
        self._rr = {"prep": 0, "apply": 0}
        self._inflight = 0
        self._stop = False
        self._pause = False  # rank 0: end the serving period
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self._prewarm_compiles = 0
        self._serve_snap = compilestats.snapshot()
        self._t_started = time.perf_counter()

    # -- admission ------------------------------------------------------
    def admit(self, name: str, initial, queries=(), *,
              setup: Optional[Callable] = None, max_queue: int = 64,
              coalesce: int = 8, batch: Optional[int] = None,
              out_capacity: Optional[int] = None,
              update_batch: Optional[int] = None,
              recover: bool = True) -> TenantHandle:
        """Admit one tenant: build its session (on the POOL's device),
        register ``queries`` (names/patterns/Query objects), run the
        optional ``setup(session)`` hook (extra relations, subscriptions),
        recover durable state if present, then prewarm — so the tenant's
        serving path never compiles.  Returns its handle.  On a mesh of
        ranks every rank admits the same tenants with the same arguments
        in the same order, outside a serving period."""
        from repro_torch.api import GraphSession
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already admitted")
        if self._ranks is not None and self._threads:
            raise RuntimeError(
                "admission on a mesh of ranks is a collective: drain() "
                "first, on every rank")
        session = GraphSession(
            initial, device=self.device, local=self.local, mesh=self.mesh,
            balance=self.balance, batch=batch, out_capacity=out_capacity,
            update_batch=update_batch or self.update_batch)
        for q in queries:
            session.register(q)
        if setup is not None:
            setup(session)
        durability = None
        replayed = 0
        if self.durable_dir:
            durability = Durability(
                os.path.join(self.durable_dir, name), session,
                snapshot_every=self.snapshot_every,
                keep_last=self.keep_last, fsync=self.fsync)
            if recover:
                durability.recover()
                replayed = durability.replayed
        snap = compilestats.snapshot()
        if self.prewarm:
            session.prewarm(horizon=self.horizon)
        spent = compilestats.since(snap)
        tenant = _Tenant(name, session, max_queue, coalesce, durability)
        tenant.stats.prewarm_compiles = spent
        tenant.stats.replayed = replayed
        if durability is not None:
            tenant.stats.snapshots = durability.snapshots
        with self._cv:
            self._tenants[name] = tenant
            self._names.append(name)
            self._prewarm_compiles += spent
            # the serving compile budget — and the throughput wall clock —
            # start AFTER the last admission
            self._serve_snap = compilestats.snapshot()
            self._t_started = time.perf_counter()
            self._cv.notify_all()
        return TenantHandle(self, name)

    def tenant(self, name: str) -> TenantHandle:
        self._tenants[name]  # raises KeyError on unknown tenants
        return TenantHandle(self, name)

    # -- ingest ---------------------------------------------------------
    @staticmethod
    def _as_dict(session, updates, weights) -> Dict[str, Tuple]:
        """Uniform {rel: (rows, weights)} form (host-side, unvalidated —
        ``prepare`` validates after coalescing)."""
        if isinstance(updates, dict):
            if weights is not None:
                raise ValueError(
                    "per-relation batches carry their own weights")
            out = {}
            for rel, batch in updates.items():
                rows, w = session.store._split(rel, batch)
                rows = np.asarray(rows)
                if w is None:
                    w = np.ones(rows.shape[0], np.int32)
                out[rel] = (rows, np.asarray(w))
            return out
        rows = np.asarray(updates)
        if weights is None:
            weights = np.ones(rows.shape[0], np.int32)
        return {"edge": (rows, np.asarray(weights))}

    def submit(self, name: str, updates, weights=None, *,
               block: bool = True, timeout: Optional[float] = None
               ) -> Optional[Ticket]:
        """Enqueue one batch for ``name``.  Bounded-queue backpressure:
        a full queue blocks this caller (``block=True``) or sheds the
        batch and returns None (``block=False`` / timeout expiry) — the
        device and the other tenants never wait on it.  On a mesh of
        ranks only rank 0 takes batches."""
        if not self.root:
            raise ValueError(
                f"submit on rank {self._ranks.rank}: rank 0 is the pool's "
                "ingress on a mesh of ranks")
        t = self._tenants[name]
        if t.quarantined:
            raise RuntimeError(
                f"tenant {name!r} is quarantined after "
                f"{self.quarantine_after} consecutive epoch failures")
        batches = self._as_dict(t.session, updates, weights)
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._cv:
            while len(t.ingest) >= t.max_queue and not self._stop:
                if not block:
                    t.stats.shed += 1
                    return None
                remaining = None if deadline is None else \
                    deadline - time.perf_counter()
                if remaining is not None and remaining <= 0 or \
                        not self._cv.wait(remaining):
                    t.stats.shed += 1
                    return None
            if self._stop:
                raise RuntimeError("pool is closed")
            ticket = Ticket()
            t.ingest.append((batches, ticket))
            t.stats.submitted += 1
            t.stats.queue_depth = len(t.ingest)
            self._inflight += 1
            self._cv.notify_all()
        if self.pipeline:
            self._ensure_started()
        return ticket

    # -- the two pipeline stages ---------------------------------------
    def _next_prep(self):
        """Round-robin pick: one tenant with queued work and a free
        prepared slot; drains its coalesce group.  Caller holds _cv."""
        n = len(self._names)
        for k in range(n):
            i = (self._rr["prep"] + k) % n
            t = self._tenants[self._names[i]]
            if not t.ingest or t.prepared is not None or t.quarantined:
                continue
            self._rr["prep"] = i + 1
            group = [t.ingest.popleft()]
            rows = sum(r.shape[0] for r, _w in group[0][0].values())
            cap = t.session.update_batch
            while t.ingest and len(group) < t.coalesce:
                nxt_rows = sum(r.shape[0]
                               for r, _w in t.ingest[0][0].values())
                if rows + nxt_rows > cap:
                    break  # keep the pinned probe shape
                group.append(t.ingest.popleft())
                rows += nxt_rows
            t.stats.queue_depth = len(t.ingest)
            self._cv.notify_all()  # queue space freed: unblock submitters
            return t, group
        return None

    @staticmethod
    def _merge(group) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Concatenate a coalesce group's per-relation batches — exact
        under signed-weight netting (normalize sums weights per tuple)."""
        if len(group) == 1:
            return group[0][0]
        merged: Dict[str, List] = {}
        for batches, _ticket in group:
            for rel, (rows, w) in batches.items():
                merged.setdefault(rel, []).append((rows, w))
        return {rel: (np.concatenate([r for r, _ in parts]),
                      np.concatenate([w for _, w in parts]))
                for rel, parts in merged.items()}

    def _prep_one(self, t: _Tenant, group) -> bool:
        """Stage A for one coalesce group (host-only: ``prepare`` is numpy
        and must stay so — this thread never touches the device).  Returns
        False when the group failed validation (tickets carry the
        error)."""
        tickets = [ticket for _b, ticket in group]
        t0 = time.perf_counter()
        try:
            faults.fire("pool.prep")
            prep = t.session.prepare(self._merge(group))
        except Exception as e:  # bad batch: fail its tickets, keep serving
            self._fail_group(t, tickets, e)
            return False
        ms = (time.perf_counter() - t0) * 1e3
        with self._cv:
            if not t.quarantined:
                t.prepared = (prep, tickets, ms)
                self._cv.notify_all()
                return True
        # the fence tripped while we were preparing: fail, don't apply
        err = RuntimeError(f"tenant {t.name!r} is quarantined")
        self._fail_group(t, tickets, err, count_failure=False)
        return False

    def _fail_group(self, t: _Tenant, tickets, error, *,
                    count_failure: bool = True) -> None:
        """Fail one group's tickets; bump the consecutive-failure count
        and trip the quarantine fence when it reaches the threshold
        (failing everything still queued — a poisoned tenant must not
        spin the shared apply thread forever)."""
        dropped = []
        with self._cv:
            t.stats.failed += len(tickets)
            self._inflight -= len(tickets)
            if count_failure:
                t.consecutive_failures += 1
            if (not t.quarantined and self.quarantine_after > 0
                    and t.consecutive_failures >= self.quarantine_after):
                t.quarantined = True
                t.stats.quarantined = True
                while t.ingest:
                    dropped.append(t.ingest.popleft()[1])
                if t.prepared is not None:
                    dropped.extend(t.prepared[1])
                    t.prepared = None
                t.stats.failed += len(dropped)
                self._inflight -= len(dropped)
                t.stats.queue_depth = 0
            self._cv.notify_all()
        for ticket in tickets:
            ticket._resolve(error=error)
        if dropped:
            qerr = RuntimeError(
                f"tenant {t.name!r} quarantined after "
                f"{t.consecutive_failures} consecutive epoch failures")
            for ticket in dropped:
                ticket._resolve(error=qerr)

    def _next_apply(self):
        """Round-robin pick of one tenant with a prepared epoch; takes the
        slot (freeing it for the prep stage).  Caller holds _cv."""
        n = len(self._names)
        for k in range(n):
            i = (self._rr["apply"] + k) % n
            t = self._tenants[self._names[i]]
            if t.prepared is None:
                continue
            self._rr["apply"] = i + 1
            job = t.prepared
            t.prepared = None
            self._cv.notify_all()
            return (t,) + job
        return None

    def _wal_log(self, t: _Tenant, raw) -> Optional[int]:
        """Durably append one epoch's raw batches with bounded retry.

        Each :class:`WalError` rolls back the partial record
        (``abort_last``), counts in ``stats.wal_errors`` and retries
        after a linear backoff; when ``wal_retries`` retries are
        exhausted the tenant LOUDLY degrades to non-durable serving
        (``stats.wal_degraded``) instead of stalling the shared apply
        thread — epochs keep committing, recovery just can't replay
        them.  Returns the logged epoch, or None once degraded."""
        last: Optional[WalError] = None
        for attempt in range(self.wal_retries + 1):
            if last is not None:
                try:
                    t.durability.wal.abort_last()
                except WalError:
                    pass  # torn tail is tolerated by replay anyway
                time.sleep(self.wal_backoff_s * attempt)
            try:
                return t.durability.log(raw)
            except WalError as e:
                last = e
                with self._cv:
                    t.stats.wal_errors += 1
        try:
            t.durability.wal.abort_last()
        except WalError:
            pass
        with self._cv:
            t.durable = False
            t.stats.wal_degraded = True
        return None

    def _sync_robustness(self, t: _Tenant, faults_before: int) -> None:
        """Mirror the session store's escalation counters (absolute —
        the store is per-tenant) and attribute newly injected faults."""
        st = t.session.store.stats
        with self._cv:
            t.stats.escalations = st.escalations
            t.stats.replays = st.replays
            t.stats.escalation_compiles = st.escalation_compiles
            t.stats.faults_injected += len(faults.injected()) - faults_before

    def _device_scope(self):
        """The apply stage's device context: its launches go to the pool's
        card whatever device the calling thread had current."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _apply_one(self, t: _Tenant, prep, tickets, prep_ms):
        """Stage B for one prepared epoch: WAL append (bounded retry /
        degrade), device apply (overflow escalation + replay happens
        INSIDE ``session.update``), snapshot cadence, ticket resolution.
        A failed apply aborts the epoch's WAL record so recovery never
        replays a batch the live run rejected; a kernel that fails to
        build or launch fails the epoch the same way."""
        if self._ranks is not None:
            return self._apply_ranked(t, prep, tickets, prep_ms)
        t0 = time.perf_counter()
        faults_before = len(faults.injected())
        logged = False
        try:
            faults.fire("pool.apply")
            if t.durability is not None and t.durable:
                epoch = self._wal_log(t, prep.raw)
                logged = epoch is not None
                if logged and self.on_logged is not None:
                    self.on_logged(t.name, epoch)
            with self._device_scope():
                res = t.session.update(prepared=prep)
                if t.durability is not None and t.durable:
                    self._snapshot(t)
        except Exception as e:
            self._failed(t, tickets, e, logged, faults_before)
            return
        self._retired(t, len(tickets), prep_ms,
                      (time.perf_counter() - t0) * 1e3, faults_before)
        for ticket in tickets:
            ticket._resolve(result=res)

    def _snapshot(self, t: _Tenant) -> None:
        """The snapshot cadence after a committed epoch: the epoch is
        already durable in the WAL, so a failed snapshot only skips the
        cadence, never the commit."""
        try:
            t.durability.maybe_snapshot()
        except Exception:
            with self._cv:
                t.stats.wal_errors += 1

    def _failed(self, t: _Tenant, tickets, error, logged: bool,
                faults_before: int) -> None:
        """A failed epoch: abort its WAL record (recovery must not replay
        a batch the live run rejected) and fail its group."""
        if logged:
            with contextlib.suppress(WalError):
                t.durability.wal.abort_last()
        self._sync_robustness(t, faults_before)
        self._fail_group(t, tickets, error)

    def _retired(self, t: _Tenant, n: int, prep_ms: float, ms: float,
                 faults_before: int) -> None:
        """A committed epoch of ``n`` batches: the tenant's counters (and
        on rank 0 the batches in flight)."""
        self._sync_robustness(t, faults_before)
        with self._cv:
            t.consecutive_failures = 0
            t.stats.epochs += 1
            t.stats.retired += n
            t.stats.coalesced_away += n - 1
            t.stats.prep_ms.append(prep_ms)
            t.stats.apply_ms.append(ms)
            if t.durability is not None:
                t.stats.snapshots = t.durability.snapshots
            if self.root:
                self._inflight -= n
            self._cv.notify_all()

    # -- a mesh of ranks: the schedule records ---------------------------
    def _send(self, op: str, **fields) -> None:
        """Rank 0: broadcast one schedule record (``apply``, ``idle`` or
        ``stop``) with the tenants fenced off so far."""
        from repro_torch.core.exchange import broadcast_object
        with self._cv:
            fenced = [n for n in self._names if self._tenants[n].quarantined]
        broadcast_object(dict(fields, op=op, fenced=fenced), self._ranks)

    def _apply_ranked(self, t: _Tenant, prep, tickets, prep_ms):
        """Rank 0's stage B on a mesh of ranks: the WAL append (rank 0's
        alone; a failure there fails the group before any record), then
        the record, then the apply every rank makes (``_run_record``)."""
        t0 = time.perf_counter()
        faults_before = len(faults.injected())
        logged = False
        try:
            if t.durability is not None and t.durable:
                epoch = self._wal_log(t, prep.raw)
                logged = epoch is not None
                if logged and self.on_logged is not None:
                    self.on_logged(t.name, epoch)
        except Exception as e:
            self._failed(t, tickets, e, logged, faults_before)
            return
        durable = t.durability is not None and t.durable
        snap = durable and t.durability.due(t.session.epoch + 1)
        self._send("apply", tenant=t.name, raw=prep.raw, durable=durable,
                   snapshot=snap, tickets=len(tickets))
        res, err = self._run_record(t, prep, snap)
        if err is not None:
            self._failed(t, tickets, err, logged, faults_before)
            return
        self._retired(t, len(tickets), prep_ms,
                      (time.perf_counter() - t0) * 1e3, faults_before)
        for ticket in tickets:
            ticket._resolve(result=res)

    def _run_record(self, t: _Tenant, prep, snapshot: bool):
        """One scheduled epoch on this rank, the same on every rank: the
        ``pool.apply`` point, the update, the snapshot when the record
        says it is due, then a check that every rank reached the same
        outcome (a rank that diverged fails the job).  Returns (result,
        error)."""
        from repro_torch.core.exchange import per_rank
        res = err = None
        try:
            faults.fire("pool.apply")
            with self._device_scope():
                res = t.session.update(prepared=prep)
                if snapshot:
                    self._snapshot(t)
        except Exception as e:
            err = e
        outcomes = per_rank(int(err is not None), self._ranks)
        if len(set(outcomes)) != 1:
            raise RuntimeError(
                f"tenant {t.name!r} epoch {t.session.epoch}: the ranks' "
                f"outcomes differ ({outcomes}, 1 = failed)") from err
        return res, err

    def _follow(self) -> None:
        """A rank other than 0: apply rank 0's records until a stop."""
        from repro_torch.core.exchange import broadcast_object
        while True:
            rec = broadcast_object(None, self._ranks)
            for name in rec["fenced"]:
                self._tenants[name].quarantined = True
                self._tenants[name].stats.quarantined = True
            if rec["op"] == "stop":
                return
            if rec["op"] != "apply":
                continue  # idle: rank 0 keeps the group alive
            t = self._tenants[rec["tenant"]]
            if t.durability is not None and not rec["durable"] and t.durable:
                t.durable = False
                t.stats.wal_degraded = True
            t0 = time.perf_counter()
            faults_before = len(faults.injected())
            prep = t.session.prepare(rec["raw"])
            _, err = self._run_record(t, prep, rec["snapshot"])
            if err is not None:
                self._sync_robustness(t, faults_before)
                with self._cv:
                    t.stats.failed += rec["tickets"]
                continue
            self._retired(t, rec["tickets"], 0.0,
                          (time.perf_counter() - t0) * 1e3, faults_before)

    # -- threads --------------------------------------------------------
    def _ensure_started(self):
        with self._cv:
            if self._threads or self._stop:
                return
            self._threads = [
                threading.Thread(target=self._prep_loop,
                                 name="pool-prep", daemon=True),
                threading.Thread(target=self._apply_loop if self._ranks
                                 is None else self._root_loop,
                                 name="pool-apply", daemon=True)]
            for th in self._threads:
                th.start()

    def _prep_loop(self):
        while True:
            with self._cv:
                job = None
                while not (self._stop or self._pause):
                    job = self._next_prep()
                    if job is not None:
                        break
                    self._cv.wait(0.1)
                if job is None:
                    return
            self._prep_one(*job)

    def _root_loop(self):
        """Rank 0's apply thread on a mesh of ranks: each prepared epoch
        behind its record, an idle record after ``idle_s`` without one,
        and a stop record to end the serving period (``drain``/``close``)
        once nothing is in flight, or at once when the pool closes
        without draining."""
        last = time.monotonic()
        try:
            while True:
                with self._cv:
                    while True:
                        job = self._next_apply()
                        if job is not None:
                            break
                        if self._stop or (self._pause
                                          and self._inflight == 0):
                            break
                        left = self.idle_s - (time.monotonic() - last)
                        if left <= 0:
                            break
                        self._cv.wait(min(left, 0.1))
                    stopping = job is None and (
                        self._stop or (self._pause and self._inflight == 0))
                if job is not None:
                    self._apply_one(*job)
                elif stopping:
                    self._send("stop")
                    return
                else:
                    self._send("idle")
                last = time.monotonic()
        except BaseException as e:
            with self._cv:
                self._error = e
                self._cv.notify_all()
            raise

    def _apply_loop(self):
        while True:
            with self._cv:
                job = None
                while not self._stop:
                    job = self._next_apply()
                    if job is not None:
                        break
                    self._cv.wait(0.1)
                if job is None:
                    return
            try:
                self._apply_one(*job)
            except BaseException as e:  # pragma: no cover - fatal only
                with self._cv:
                    self._error = e
                    self._cv.notify_all()
                raise

    # -- lifecycle ------------------------------------------------------
    def pump(self):
        """Synchronous pipeline pump (``pipeline=False`` mode and tests):
        run prep+apply inline on the calling thread until idle.  On a mesh
        of ranks rank 0 then sends a stop record, and the other ranks
        follow the records until it."""
        if self._ranks is not None:
            if not self.root:
                return self._follow()
            if self._threads:
                raise RuntimeError("pump() while the pipeline threads serve")
        while True:
            with self._cv:
                job = self._next_prep()
            if job is not None:
                if not self._prep_one(*job):
                    continue
            with self._cv:
                ajob = self._next_apply()
            if ajob is None:
                if job is None:
                    break
                continue
            self._apply_one(*ajob)
        if self._ranks is not None:
            self._send("stop")

    def drain(self, timeout: Optional[float] = None):
        """Block until every accepted batch has retired (or failed).  On a
        mesh of ranks it ends the serving period, on every rank."""
        if not self.pipeline:
            self.pump()
            return
        if self._ranks is not None and not self.root:
            self._follow()
            return
        self._ensure_started()
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._cv:
            while self._inflight > 0:
                if self._error is not None:
                    raise RuntimeError(
                        "pool apply thread died") from self._error
                remaining = None if deadline is None else \
                    deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{self._inflight} batches still in flight")
                self._cv.wait(0.1 if remaining is None
                              else min(remaining, 0.1))
        if self._ranks is not None:
            self._end_period()

    def _end_period(self) -> None:
        """Rank 0: have the apply thread send the stop record, and end
        both threads (the next submit starts them again)."""
        with self._cv:
            self._pause = True
            self._cv.notify_all()
        for th in self._threads:
            th.join()
        with self._cv:
            self._threads = []
            self._pause = False
            if self._error is not None:
                raise RuntimeError("pool apply thread died") from self._error

    def close(self, drain: bool = True):
        """Drain (optionally), stop the pipeline threads, flush WALs.  On
        a mesh of ranks every rank calls it: rank 0 sends one stop
        record (after draining, or at once), the others follow until
        it."""
        if not self._stop:
            if self._ranks is None:
                if drain:
                    self.drain()
            elif drain or not self.root:
                self.drain()
            else:
                with self._cv:
                    self._stop = True
                    self._cv.notify_all()
                if self._threads:
                    self._end_period()
                else:
                    self._send("stop")
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for th in self._threads:
            th.join(timeout=10)
        self._threads = []
        for t in self._tenants.values():
            if t.durability is not None:
                t.durability.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    # -- observability --------------------------------------------------
    def stats(self) -> ServeStats:
        """Pool aggregate: per-tenant counters + the serving compile
        budget (compile events since the last admission's prewarm)."""
        with self._cv:
            tenants = {name: t.stats for name, t in self._tenants.items()}
            return ServeStats(
                tenants=tenants,
                prewarm_compiles=self._prewarm_compiles,
                serve_compiles=compilestats.since(self._serve_snap),
                wall_s=time.perf_counter() - self._t_started)
