"""Serving observability: per-tenant counters + pool-level aggregates.

Everything here is plain host bookkeeping updated under the pool's lock —
no device calls, no torch imports — so reading stats never perturbs the
epoch pipeline.  ``ServeStats.render()`` is the human surface the
``serve --concurrent`` CLI prints; the dict forms feed the serving
benchmark's JSON rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def percentiles(samples: List[float]) -> Dict[str, float]:
    """p50/p95/p99/max (milliseconds in, milliseconds out) plus the
    p99/p50 tail ratio the latency gates key on; zeros when empty."""
    if not samples:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0,
                "p99_p50_ratio": 0.0}
    p50, p95, p99 = np.percentile(samples, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "max": float(max(samples)),
            "p99_p50_ratio": float(p99 / max(p50, 1e-9))}


@dataclasses.dataclass
class TenantStats:
    """One tenant's serving counters.

    ``submitted`` counts accepted batches; ``shed`` counts batches the
    bounded ingest queue refused (backpressure — the mesh never stalled
    for them); ``retired`` counts batches whose ticket resolved.
    ``epochs`` is the number of DEVICE epochs run — adaptive coalescing
    folds up to ``coalesce`` queued batches into one epoch, so
    ``retired - epochs`` (= ``coalesced_away``) batches rode a shared
    commit.  ``prep_ms``/``apply_ms`` time the two pipeline stages
    (host pack vs device normalize+dataflow+commit) per epoch.
    """

    name: str
    submitted: int = 0
    retired: int = 0
    shed: int = 0
    failed: int = 0
    epochs: int = 0
    coalesced_away: int = 0
    queue_depth: int = 0
    snapshots: int = 0
    replayed: int = 0
    prewarm_compiles: int = 0
    # -- robustness counters (DESIGN.md §10).  ``escalations`` counts
    # capacity-rung bumps the engines made mid-serve; ``replays`` the
    # epochs transparently re-run after one; ``escalation_compiles`` keeps
    # the JAX package's key and stays 0 (the port re-prewarms nothing
    # after an escalation).  ``wal_errors`` counts append attempts
    # that failed and were retried; ``wal_degraded`` latches once retries
    # were exhausted and the tenant now serves WITHOUT durability.
    escalations: int = 0
    replays: int = 0
    escalation_compiles: int = 0
    wal_errors: int = 0
    wal_degraded: bool = False
    quarantined: bool = False
    faults_injected: int = 0
    prep_ms: List[float] = dataclasses.field(default_factory=list)
    apply_ms: List[float] = dataclasses.field(default_factory=list)

    def latency(self) -> Dict[str, float]:
        return percentiles(self.apply_ms)

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in
             ("name", "submitted", "retired", "shed", "failed", "epochs",
              "coalesced_away", "queue_depth", "snapshots", "replayed",
              "prewarm_compiles", "escalations", "replays",
              "escalation_compiles", "wal_errors", "wal_degraded",
              "quarantined", "faults_injected")}
        d["latency_ms"] = self.latency()
        d["prep_ms_p50"] = float(np.median(self.prep_ms)) \
            if self.prep_ms else 0.0
        return d


@dataclasses.dataclass
class ServeStats:
    """Pool-level aggregate over every tenant's :class:`TenantStats`.

    ``serve_compiles`` is the number of compile events (kernel libraries
    built or loaded, :mod:`repro_torch.core.compilestats`) recorded AFTER
    the last tenant admission finished its prewarm — the serving-path
    compile budget; steady state it must be ZERO.
    """

    tenants: Dict[str, TenantStats] = dataclasses.field(default_factory=dict)
    prewarm_compiles: int = 0
    serve_compiles: int = 0
    wall_s: float = 0.0

    def aggregate(self) -> dict:
        eps = sum(t.epochs for t in self.tenants.values())
        ret = sum(t.retired for t in self.tenants.values())
        all_lat = [ms for t in self.tenants.values() for ms in t.apply_ms]
        return {
            "tenants": len(self.tenants),
            "epochs": eps,
            "retired": ret,
            "shed": sum(t.shed for t in self.tenants.values()),
            "snapshots": sum(t.snapshots for t in self.tenants.values()),
            "replayed": sum(t.replayed for t in self.tenants.values()),
            "epochs_per_s": eps / self.wall_s if self.wall_s else 0.0,
            "batches_per_s": ret / self.wall_s if self.wall_s else 0.0,
            "latency_ms": percentiles(all_lat),
            "prewarm_compiles": self.prewarm_compiles,
            "serve_compiles": self.serve_compiles,
            "escalations": sum(t.escalations for t in self.tenants.values()),
            "replays": sum(t.replays for t in self.tenants.values()),
            "escalation_compiles": sum(
                t.escalation_compiles for t in self.tenants.values()),
            "failed": sum(t.failed for t in self.tenants.values()),
            "wal_errors": sum(t.wal_errors for t in self.tenants.values()),
            "wal_degraded": sum(
                1 for t in self.tenants.values() if t.wal_degraded),
            "quarantined": sum(
                1 for t in self.tenants.values() if t.quarantined),
            "faults_injected": sum(
                t.faults_injected for t in self.tenants.values()),
        }

    def render(self) -> str:
        agg = self.aggregate()
        lat = agg["latency_ms"]
        lines = [
            f"pool: {agg['tenants']} tenants, {agg['epochs']} device epochs "
            f"({agg['retired']} batches, {agg['shed']} shed) in "
            f"{self.wall_s:.1f}s — {agg['batches_per_s']:,.1f} batches/s; "
            f"latency p50 {lat['p50']:.1f} ms  p95 {lat['p95']:.1f} ms  "
            f"p99 {lat['p99']:.1f} ms (p99/p50 "
            f"{lat['p99_p50_ratio']:.1f}x); compile events: "
            f"{self.prewarm_compiles} admission + {self.serve_compiles} "
            "serving"]
        if (agg["escalations"] or agg["failed"] or agg["wal_errors"]
                or agg["quarantined"] or agg["faults_injected"]):
            lines.append(
                f"robustness: {agg['escalations']} escalations / "
                f"{agg['replays']} replays "
                f"({agg['escalation_compiles']} compiles), "
                f"{agg['failed']} failed batches, {agg['wal_errors']} WAL "
                f"errors ({agg['wal_degraded']} degraded tenants), "
                f"{agg['quarantined']} quarantined, "
                f"{agg['faults_injected']} faults injected")
        for name in sorted(self.tenants):
            t = self.tenants[name]
            tl = t.latency()
            flags = ""
            if t.escalations or t.failed or t.wal_errors:
                flags = (f"; {t.escalations} escalations/"
                         f"{t.replays} replays, {t.failed} failed, "
                         f"{t.wal_errors} wal_errors")
            if t.wal_degraded:
                flags += " [NON-DURABLE]"
            if t.quarantined:
                flags += " [QUARANTINED]"
            lines.append(
                f"  {name}: {t.epochs} epochs / {t.retired} batches "
                f"({t.coalesced_away} coalesced, {t.shed} shed, depth "
                f"{t.queue_depth}); apply p50 {tl['p50']:.1f} ms p99 "
                f"{tl['p99']:.1f} ms; {t.snapshots} snapshots, "
                f"{t.replayed} replayed" + flags)
        return "\n".join(lines)
