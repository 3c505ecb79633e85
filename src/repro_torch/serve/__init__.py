"""Concurrent serving subsystem (DESIGN.md §9), the JAX package's
``repro.serve`` on one device.

Multi-tenant sessions, pipelined epochs and snapshot/WAL failover — the
serving layer over :mod:`repro_torch.api`:

- :class:`SessionPool` / :class:`TenantHandle` — N tenants, one device,
  bounded ingest queues with backpressure, adaptive batch coalescing,
  prep/apply pipeline, admission prewarm;
- :class:`WriteAheadLog` / :class:`Durability` — raw-batch WAL +
  snapshot cadence; bit-exact restore-and-replay recovery, across the
  two packages;
- :class:`ServeStats` / :class:`TenantStats` — queue depth, latency
  percentiles, compile events, snapshot/replay counters.
"""
from repro_torch.serve.pool import SessionPool, TenantHandle, Ticket
from repro_torch.serve.stats import ServeStats, TenantStats, percentiles
from repro_torch.serve.wal import Durability, WriteAheadLog

__all__ = ["SessionPool", "TenantHandle", "Ticket", "ServeStats",
           "TenantStats", "percentiles", "Durability", "WriteAheadLog"]
