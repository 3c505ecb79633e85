"""GraphSession: one graph, many standing queries, one commit per epoch.

The public entry point of the port: a session owns the dynamic graph — one
device-resident :class:`~repro_torch.core.delta.RegionStore` holding the
edge relation, any n-ary relations added with :meth:`add_relation`, and
every multi-version index projection — and queries register against it.
``session.update`` runs ONE normalize → dAQ_1..dAQ_n for every registered
query → ONE commit per epoch off the shared regions.

Everything runs on the card (``device="cuda"``, the default) unless the
caller asks for the CPU, where every kernel wrapper takes its plain
version.  A session is local (one device's engine) or a mesh session: w
workers as a leading tensor axis on the session's device, every region
hash-sharded over them and every query a
:class:`~repro_torch.core.distributed.DistDeltaBigJoin`.  A mesh of R
ranks (``launch.mesh.init_rank_mesh``) spreads the w workers over R
processes: each rank builds the session with the same arguments and
makes the same calls, holds its workers' shards, and reads the whole
mesh's answer from ``count()`` and ``update()``; a snapshot is gathered
to rank 0 and a restore scattered from it.  An update is a
transaction (a failure rolls the store back to the epoch boundary), and
:meth:`GraphSession.snapshot` / :meth:`GraphSession.restore` carry a
session's state in the JAX package's snapshot format, either way.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.dsl import parse_pattern, pattern_of
from repro_torch.core import compilestats
from repro_torch.core import delta as _delta
from repro_torch.core.bigjoin import BigJoinConfig, run_bigjoin
from repro_torch.core.csr import pow2_capacity, resolve_device
from repro_torch.core.plan import Plan, make_plan
from repro_torch.core.query import (EDGE, Query, fractional_edge_cover,
                                    query_by_name)
from repro_torch.errors import (CapacityOverflow, ESCALATES_BATCH,
                                ESCALATES_OUT, ESCALATES_ROUTE)


def _pow2(n: int) -> int:
    return pow2_capacity(max(int(n), 1))


@dataclasses.dataclass(frozen=True)
class Sizing:
    """Derived capacities for one query (see :func:`auto_sizing`)."""

    batch: int  # B' — per-step proposal budget (a worker's on a mesh)
    out_capacity: int  # collect-mode output rows per dataflow run
    route_capacity: int  # request slots a peer pair (the mesh only)


def auto_sizing(query: Query, num_edges: int, num_workers: int = 1,
                update_batch: int = 2048) -> Sizing:
    """Capacity defaults from the AGM bound (§1.1): with |E| = IN and
    fractional edge-cover number rho*, one seed edge extends to at most
    IN^(rho*-1) results.  ``batch`` is that bound clamped to [1024, 8192]
    and split over the workers, no lower than 256; ``out_capacity`` one
    epoch's worst-case signed output n_atoms · |dR| · IN^(rho*-1),
    clamped to [2^14, 2^22]; ``route_capacity`` the BiGJoin-S
    balls-into-bins regime, 4·batch/w a peer pair, floor 64
    (``distributed.default_delta_config``'s)."""
    E = max(int(num_edges), 2)
    rho = fractional_edge_cover(query)
    per_seed = float(E) ** max(rho - 1.0, 0.0)
    batch = int(np.clip(_pow2(per_seed), 1024, 8192))
    batch = max(batch // max(num_workers, 1), 256)
    out_rows = query.num_atoms * update_batch * per_seed
    out_capacity = int(np.clip(_pow2(out_rows), 1 << 14, 1 << 22))
    return Sizing(batch, out_capacity, _route_for(batch, num_workers))


def _route_for(batch: int, num_workers: int) -> int:
    return max(4 * batch // max(num_workers, 1), 64)


@dataclasses.dataclass
class EpochResult:
    """What one ``session.update`` produced: the normalized batch and each
    registered query's signed output delta (keyed by handle name).

    ``ins`` / ``dels`` are the edge relation's normalized rows (empty when
    the epoch touched other relations only); ``by_rel`` carries every
    relation's normalized ``(ins, dels)`` pair.  ``compile_events`` counts
    the compile events (kernel libraries built or loaded,
    :mod:`~repro_torch.core.compilestats`) the epoch triggered: zero on
    every epoch after :meth:`GraphSession.prewarm`."""

    epoch: int
    ins: np.ndarray
    dels: np.ndarray
    deltas: Dict[str, _delta.DeltaResult]
    by_rel: Dict[str, Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    compile_events: int = 0

    @property
    def is_noop(self) -> bool:
        return all(i.size == 0 and d.size == 0
                   for i, d in self.by_rel.values()) \
            if self.by_rel else (self.ins.size == 0 and self.dels.size == 0)

    def advance(self, live: np.ndarray) -> np.ndarray:
        """Advance a host live-edge array by this epoch's normalized delta
        (np.unique row order, same as ``session.edges``)."""
        if self.is_noop:
            return live
        p = _delta._pack2(live[:, 0], live[:, 1])
        if p.size > 1 and not (p[1:] > p[:-1]).all():
            kept = _delta._diff_rows(live, self.dels)
            return np.unique(np.concatenate([kept, self.ins]), axis=0)
        # sorted live rows: an O(|E|) merge of the small delta, not a sort
        d = np.sort(_delta._pack2(self.dels[:, 0], self.dels[:, 1]))
        at = np.searchsorted(p, d)
        hit = at < p.size
        hit[hit] = p[at[hit]] == d[hit]
        p = np.delete(p, at[hit])
        i = np.unique(_delta._pack2(self.ins[:, 0], self.ins[:, 1]))
        at = np.searchsorted(p, i)
        new = (at >= p.size) | (p[np.minimum(at, max(p.size - 1, 0))] != i) \
            if p.size else np.ones(i.size, bool)
        return _delta._unpack2(np.insert(p, at[new], i[new]))


class QueryHandle:
    """One standing query registered on a :class:`GraphSession`: static
    :meth:`count` / :meth:`enumerate` over the live graph, and the standing
    delta fed by ``session.update`` (``last_delta``, ``net_change``,
    :meth:`subscribe` callbacks)."""

    def __init__(self, session: "GraphSession", name: str, query: Query,
                 batch: Optional[int] = None,
                 out_capacity: Optional[int] = None):
        self.session = session
        self.name = name
        self.query = query
        self._batch = batch
        self._out_capacity = out_capacity
        self._engine: Optional[_delta.DeltaBigJoin] = None
        self.last_delta: Optional[_delta.DeltaResult] = None
        self.net_change = 0
        self._subscribers: List[Callable] = []

    @property
    def engine(self) -> _delta.DeltaBigJoin:
        """The standing delta engine (shares the session's RegionStore),
        built lazily on the first update epoch."""
        if self._engine is None:
            self._engine = self.session._make_engine(
                self.query, self._batch, self._out_capacity)
        return self._engine

    def count(self) -> int:
        """Exact instance count over the CURRENT graph."""
        return self.session._static_eval(self.query, "count").count

    def enumerate(self) -> Tuple[np.ndarray, np.ndarray]:
        """All instances over the current graph: (tuples [N, m], weights)."""
        res = self.session._static_eval(self.query, "collect")
        m = self.query.num_attrs
        if res.tuples is None:
            return (np.zeros((0, m), np.int32), np.zeros(0, np.int32))
        return res.tuples, res.weights

    def subscribe(self, fn: Callable[[int, _delta.DeltaResult], None]):
        """Call ``fn(epoch, delta_result)`` after every update epoch."""
        self._subscribers.append(fn)
        return fn

    def _deliver(self, epoch: int, res: _delta.DeltaResult):
        self.last_delta = res
        self.net_change += res.count_delta
        for fn in self._subscribers:
            fn(epoch, res)


class GraphSession:
    """The facade: owns one dynamic graph and serves many standing queries.

    ``device=None`` means ``"cuda"`` and raises when CUDA is absent; pass
    ``device="cpu"`` to run the plain versions on the host.

    Engine selection: ``local=True`` runs one device's engine; ``local=
    False`` hash-shards every region over the workers of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.WorkerMesh`; without one,
    ``make_host_mesh(4, device)``) and runs the request/response dataflow
    of §3.4, with BiGJoin-S Balance under ``balance=True``.  The default,
    ``local=None``, is local unless a ``mesh`` is given: the card is one
    device, as the JAX rule ``mesh is None and device_count() == 1``
    reads there.  A mesh's device must be the session's.
    ``prewarm=True`` runs :meth:`prewarm` at every :meth:`register`."""

    def __init__(self, initial_edges, *, device=None, local: bool = None,
                 mesh=None, balance: bool = False,
                 batch: Optional[int] = None,
                 out_capacity: Optional[int] = None,
                 update_batch: int = 2048,
                 compact_ratio: float = 0.5,
                 prewarm: bool = False):
        if local is None:
            local = mesh is None
        self.local = bool(local)
        self.balance = bool(balance)
        if mesh is not None and not self.local and device is None:
            device = mesh.device  # the mesh names the session's device
        self.device = resolve_device(device)
        if self.local:
            self.mesh, self.w = None, 1
        else:
            from repro_torch.launch.mesh import (DEFAULT_WORKERS,
                                                 make_host_mesh)
            if mesh is None:
                mesh = make_host_mesh(DEFAULT_WORKERS, self.device)
            elif resolve_device(mesh.device) != self.device:
                raise ValueError(f"the mesh's device {mesh.device} is not "
                                 f"the session's {self.device}")
            self.mesh, self.w = mesh, int(mesh.num_workers)
        self._batch_override = batch
        self._out_override = out_capacity
        self.update_batch = update_batch
        self.store = _delta.RegionStore(
            initial_edges, shard_w=0 if self.local else self.w,
            compact_ratio=compact_ratio, device=self.device, mesh=self.mesh)
        self.handles: Dict[str, QueryHandle] = {}
        self.epoch = 0
        self._static_plans: Dict[Query, Plan] = {}
        self.auto_prewarm = bool(prewarm)

    # -- registration -------------------------------------------------------
    def register(self, pattern, name: Optional[str] = None,
                 symmetric: bool = False,
                 batch: Optional[int] = None,
                 out_capacity: Optional[int] = None) -> QueryHandle:
        """Register a standing query (a :class:`Query`, a DSL string or a
        registry name) and return its handle; the same name twice returns
        the existing handle."""
        if isinstance(pattern, Query):
            q = pattern
        elif ":=" in pattern:
            q = parse_pattern(pattern, name=name)
        else:
            q = query_by_name(pattern, symmetric=symmetric)
        name = name or q.name
        if name in self.handles:
            if self.handles[name].query != q:
                raise ValueError(
                    f"query name {name!r} already registered with a "
                    "different pattern")
            return self.handles[name]
        # declare any relation the query reads that the store does not hold
        # yet (created empty; add_relation() seeds it), so
        # ``update({"tri": ...})`` works right after registration
        for atom in q.atoms:
            if atom.rel not in self.store.relations:
                self.store.add_relation(
                    atom.rel, np.zeros((0, atom.arity), np.int32))
        handle = QueryHandle(self, name, q, batch, out_capacity)
        self.handles[name] = handle
        if self.auto_prewarm:
            self.prewarm()
        return handle

    def prewarm(self, horizon: Optional[int] = None) -> int:
        """The admission prewarm: build every registered query's engine,
        pin the store's probe and delta marks to ``update_batch``, and on
        the card load every kernel library an epoch launches
        (:meth:`DeltaBigJoin.prewarm`), so that each later epoch with
        batches of at most ``update_batch`` reports
        ``EpochResult.compile_events == 0``.  The ratchet marks then equal
        a prewarmed JAX session's, which matters because snapshots carry
        them.  ``horizon`` is the JAX signature's (the stream's expected
        churn).  Returns the compile events spent (also added to
        ``StoreStats.prewarm_compiles``)."""
        snap = compilestats.snapshot()
        # engines first: their lazily-created projections must exist
        # before the marks are pinned for every relation
        engines = [h.engine for h in self.handles.values()]
        self.store.pin_delta_marks(self.update_batch)
        for engine in engines:
            self.store.stats.prewarm_compiles += \
                engine.prewarm(self.update_batch, horizon)
        self.store._sync_compile_stats()
        return compilestats.since(snap)

    def kernel_coverage(self) -> dict:
        """Per-relation kernel-launch evidence (``RegionStore.
        kernel_coverage``): for each relation, the CUDA launches of the
        commit fold and the versioned probe a warm epoch makes.  The
        coverage gate (``launch.kernel_coverage``) asserts zero warm
        compiles and one fold launch a relation from this one dict."""
        return self.store.kernel_coverage(self.update_batch)

    def query_by_name(self, name: str) -> QueryHandle:
        """Fetch a registered handle; registers the named motif on miss."""
        return self.handles.get(name) or self.register(name)

    def __getitem__(self, name: str) -> QueryHandle:
        return self.handles[name]

    def add_relation(self, rel: str, rows: np.ndarray,
                     arity: Optional[int] = None):
        """Register one more dynamic relation (e.g. a materialized ``tri``
        relation) with its initial tuples; later ``update`` batches may
        then address it by name."""
        self.store.add_relation(rel, rows, arity=arity)

    def relation(self, rel: str) -> np.ndarray:
        """One relation's live tuples (host view)."""
        return self.store.relation_rows(rel)

    def num_tuples(self, rel: str) -> int:
        return self.store.num_tuples(rel)

    def _sizing(self, q: Query, batch, out_capacity) -> Sizing:
        # the AGM inputs ride a ratchet so |E| jitter cannot flap the
        # derived capacities
        live = self.store.base_ratchet.capacity(
            ("sizing",), self.store.max_live or self.update_batch)
        s = auto_sizing(q, live, self.w, self.update_batch)
        b = batch or self._batch_override or s.batch
        oc = out_capacity or self._out_override or s.out_capacity
        # escalation marks are floors for every rebuilt config
        r = self.store.ratchet
        b = max(b, r.peek(("cap", "batch", q.name)))
        oc = max(oc, r.peek(("cap", "out", q.name)))
        rt = max(_route_for(b, self.w),  # the route follows the final B'
                 r.peek(("cap", "route", q.name)))
        return Sizing(b, oc, rt)

    def _make_engine(self, q: Query, batch, out_capacity
                     ) -> _delta.DeltaBigJoin:
        s = self._sizing(q, batch, out_capacity)
        if self.local:
            cfg = BigJoinConfig(batch=s.batch, seed_chunk=s.batch,
                                mode="collect", out_capacity=s.out_capacity)
            return _delta.DeltaBigJoin(q, None, cfg=cfg, store=self.store)
        from repro_torch.core.distributed import (DistDeltaBigJoin,
                                                  default_delta_config)
        dcfg = default_delta_config(self.w, batch=s.batch,
                                    out_capacity=s.out_capacity,
                                    balance=self.balance)
        return DistDeltaBigJoin(q, None, mesh=self.mesh, dcfg=dcfg,
                                store=self.store)

    # -- the epoch loop -----------------------------------------------------
    def prepare(self, updates, weights=None) -> _delta.PreparedBatch:
        """Stage A of :meth:`update` on the host only (validate, pack,
        sentinel-pad)."""
        return self.store.prepare(updates, weights)

    def update(self, updates=None, weights=None, *,
               prepared: Optional[_delta.PreparedBatch] = None
               ) -> EpochResult:
        """Apply one update batch to the graph and every standing query:
        ONE normalize, each registered query's dAQ pipeline off the shared
        regions, ONE commit.  ``updates`` is an [N, 2] edge array (with
        optional ``weights``) or a per-relation dict ``{"edge": (rows, w),
        "tri": (rows, w), ...}``.  Transactional: any failure between
        staging and commit rolls the store back and re-raises."""
        snap = compilestats.snapshot()
        if prepared is None:
            prepared = self.store.prepare(updates, weights)
        elif updates is not None or weights is not None:
            raise ValueError("pass updates OR prepared=, not both")
        batches = self.store.normalize_prepared(prepared)
        e_ins, e_dels = batches.get(
            EDGE, (np.zeros((0, 2), np.int32),) * 2)
        if all(i.size == 0 and d.size == 0 for i, d in batches.values()):
            self.epoch += 1
            zero = _delta.DeltaResult(0, None, None, [])
            deltas = {name: zero for name in self.handles}
            for name, h in self.handles.items():
                h._deliver(self.epoch, zero)
            return EpochResult(self.epoch, e_ins, e_dels, deltas, batches,
                               compile_events=compilestats.since(snap))
        # touch every handle's engine BEFORE staging: a lazily-built engine
        # must create its projections first
        engines = [(name, h.engine) for name, h in self.handles.items()]
        try:
            self.store.begin_epoch(batches)
            deltas: Dict[str, _delta.DeltaResult] = {}
            for name, engine in engines:
                deltas[name] = engine.run_delta_plans(batches)
            self.store.commit(batches)
        except Exception:
            self.store.rollback()
            raise
        self.epoch += 1
        for name, h in self.handles.items():
            h._deliver(self.epoch, deltas[name])
        return EpochResult(self.epoch, e_ins, e_dels, deltas, batches,
                           compile_events=compilestats.since(snap))

    # -- durability ---------------------------------------------------------
    def snapshot(self) -> Optional[Tuple[List[np.ndarray], dict]]:
        """The session's state as ``(leaves, meta)``: the store's
        (``RegionStore.snapshot``) plus, under ``meta["session"]``, the
        epoch counter, the mesh width ``w`` and ``local``, and every handle
        (its DSL pattern and ``net_change``) — the JAX session's format.
        Save it with ``repro_torch.checkpoint.save_pytree(leaves, ...,
        extra=meta)``.  On a mesh of ranks every rank calls it (a
        collective, the session's meta included in the ranks' digest);
        rank 0 gets the one-process snapshot and the others ``None``."""
        return self.store.snapshot(extra={"session": {
            "epoch": int(self.epoch),
            "w": int(self.w),
            "local": bool(self.local),
            "update_batch": int(self.update_batch),
            "handles": {name: {"pattern": pattern_of(h.query),
                               "net_change": int(h.net_change)}
                        for name, h in self.handles.items()},
        }})

    def restore(self, leaves: Optional[List[np.ndarray]],
                meta: Optional[dict]) -> None:
        """Restore a :meth:`snapshot` (of either package's session of the
        same mesh width and mode) in place: the store's regions and
        ratchet marks, then the epoch and every handle, re-registered from
        its pattern with its ``net_change``.  A handle already registered
        under the same name keeps its object and subscribers.  On a mesh
        of ranks every rank calls it and only rank 0's arguments are read
        (the others pass ``None``): a snapshot taken at any number of
        ranks, or by the JAX package, restores at any other."""
        def check(meta):
            sess = meta.get("session", {})
            w = int(sess.get("w", self.w))
            if w != self.w:
                raise ValueError(
                    f"snapshot was taken on a {w}-worker session; this one "
                    f"has {self.w} workers — failover restores onto the "
                    "same mesh width")
            if bool(sess.get("local", self.local)) != self.local:
                raise ValueError("snapshot engine mode (local/mesh) "
                                 "mismatch")
        meta, shapes = self.store.share_snapshot(leaves, meta, check)
        sess = meta.get("session", {})
        self.store.restore(leaves, meta, shapes)
        self.epoch = int(sess.get("epoch", 0))
        for name, rec in sess.get("handles", {}).items():
            h = self.register(rec["pattern"], name=name)
            h.net_change = int(rec["net_change"])
            h.last_delta = None

    # -- static evaluation over the shared regions --------------------------
    def _static_plan(self, q: Query) -> Plan:
        """Plan reading version "old" = base + cins − cdel, i.e. the live
        committed graph, through the shared regions."""
        plan = self._static_plans.get(q)
        if plan is None:
            plan = make_plan(q, versions=("old",) * q.num_atoms)
            self.store.ensure_plan(plan)
            self._static_plans[q] = plan
        return plan

    def _escalate_static(self, q: Query, exc: CapacityOverflow,
                         s: Sizing) -> None:
        """Static-count overflow recovery: bump the per-query marks the
        delta engines use (``_sizing`` reads them as floors); re-raises
        when no named buffer can grow."""
        r = self.store.ratchet
        changed = False
        if exc.kinds & ESCALATES_OUT:
            r.escalate(("cap", "out", q.name), floor=s.out_capacity)
            changed = True
        if exc.kinds & ESCALATES_BATCH:
            r.escalate(("cap", "batch", q.name), floor=s.batch)
            changed = True
        if exc.kinds & ESCALATES_ROUTE:
            r.escalate(("cap", "route", q.name), floor=s.route_capacity)
            changed = True
        if not changed:
            raise exc
        self.store.stats.escalations += 1
        self.store.stats.replays += 1

    def _static_eval(self, q: Query, mode: str):
        """Count or enumerate ``q`` over the live graph: one device's
        dataflow, or on the mesh one program run (``run_program``) over
        the sharded regions."""
        from repro_torch.core.bigjoin import seed_tuples_for
        plan = self._static_plan(q)
        seed_rel = q.atoms[plan.seed_atom].rel
        seed = seed_tuples_for(plan,
                               {seed_rel: self.store.relation_rows(
                                   seed_rel)})
        indices = self.store.indices_for(plan)
        for attempt in range(_delta.DeltaBigJoin.MAX_ESCALATIONS + 1):
            s = self._sizing(q, None, None)  # re-read escalated floors
            out_cap = s.out_capacity if mode == "collect" else 1
            cfg = BigJoinConfig(batch=s.batch, seed_chunk=s.batch,
                                mode=mode, out_capacity=out_cap)
            try:
                if self.local:
                    return run_bigjoin(plan, indices, seed, cfg=cfg,
                                       device=self.device)
                from repro_torch.core.distributed import (
                    DistConfig, get_distributed_program, run_program)
                dcfg = DistConfig(cfg, self.w,
                                  route_capacity=s.route_capacity,
                                  balance=self.balance)
                program = get_distributed_program(plan, dcfg, self.mesh)
                return run_program(program, self.w, mode == "collect",
                                   indices, seed,
                                   np.ones(seed.shape[0], np.int32),
                                   width=plan.seed_width)
            except CapacityOverflow as exc:
                if attempt >= _delta.DeltaBigJoin.MAX_ESCALATIONS:
                    raise
                self._escalate_static(q, exc, s)
        raise AssertionError("unreachable")

    # -- introspection ------------------------------------------------------
    @property
    def edges(self) -> np.ndarray:
        """The live edge set (host mirror)."""
        return self.store.edges

    @property
    def num_edges(self) -> int:
        return int(self.store.num_edges)

    @property
    def stats(self) -> _delta.StoreStats:
        return self.store.stats
