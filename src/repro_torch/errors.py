"""Typed recoverable errors (DESIGN.md §10).

The engines used to crash on any capacity overflow with a bare
``RuntimeError("raise batch/out_capacity")`` — but the MPC bounds the
capacities are sized against (Beame–Koutris–Suciu) are probabilistic, so
under adversarially skewed streams overflow is an EXPECTED event, not a
bug.  This module gives every recoverable failure a type the drivers can
dispatch on:

- :class:`CapacityOverflow` carries *which* device buffer overflowed as a
  bitmask (out buffer, level queue, BiGJoin-S piece queue, per-peer route
  table, seed enqueue) so escalate-and-replay can bump exactly the
  offending :class:`~repro_torch.core.capacity.Ratchet` rung and re-run the
  staged epoch;
- :class:`WalError` / :class:`SnapshotError` type the durability paths so
  the serving pool can retry/degrade instead of killing a tenant;
- :class:`FaultInjected` is raised by :mod:`repro_torch.faults` fault
  points — the deterministic chaos harness.

Every class subclasses :class:`RuntimeError`: pre-existing callers that
caught ``RuntimeError`` keep working unchanged.

The overflow flags are plain ints OR-able inside jitted dataflows (the
``BigJoinState.overflow`` field is an int32 mask accumulated on device and
decoded host-side by :func:`overflow_kinds`).
"""
from __future__ import annotations

from typing import FrozenSet

# BigJoinState.overflow bitmask — one bit per distinct buffer kind.  The
# mask is OR-accumulated inside the jitted dataflow (and bit-OR-psum'd
# across mesh workers), then decoded host-side into kind names.
OVF_OUT = 1       # collect-mode output buffer (cfg.out_capacity)
OVF_QUEUE = 2     # a level queue (2·batch rows; bounded by Lemma 3.1)
OVF_PIECE = 4     # a BiGJoin-S piece queue (balance.piece_caps)
OVF_ROUTE = 8     # per-peer route table (DistConfig.route_capacity)
OVF_SEED = 16     # seed-chunk enqueue (cfg.seed_chunk / dealt chunk)

_KIND_BITS = (
    ("out", OVF_OUT),
    ("queue", OVF_QUEUE),
    ("piece", OVF_PIECE),
    ("route", OVF_ROUTE),
    ("seed", OVF_SEED),
)

# which buffer kind escalates which capacity knob
ESCALATES_BATCH = frozenset({"queue", "piece", "seed"})
ESCALATES_OUT = frozenset({"out"})
ESCALATES_ROUTE = frozenset({"route"})


def overflow_kinds(mask: int) -> FrozenSet[str]:
    """Decode an overflow bitmask into buffer-kind names."""
    return frozenset(name for name, bit in _KIND_BITS if int(mask) & bit)


class ReproError(RuntimeError):
    """Base of every typed repro error (a RuntimeError for old callers)."""


class CapacityOverflow(ReproError):
    """A static device buffer overflowed — recoverable by rung escalation.

    ``mask`` is the raw device bitmask; :attr:`kinds` names the buffers
    (``{"out", "queue", "piece", "route", "seed"}`` subsets); ``where``
    says which driver detected it (diagnostics only).
    """

    def __init__(self, mask: int, where: str = "", detail: str = ""):
        self.mask = int(mask)
        self.kinds = overflow_kinds(mask)
        self.where = where
        names = "/".join(sorted(self.kinds)) or f"mask={self.mask}"
        msg = f"capacity overflow [{names}]"
        if where:
            msg += f" in {where}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class WalError(ReproError):
    """Write-ahead log append/fsync/verify failure (retryable)."""


class SnapshotError(ReproError):
    """Snapshot write/restore failure (the WAL still covers the epochs)."""


class FaultInjected(ReproError):
    """Raised by a :mod:`repro_torch.faults` fault point when its schedule
    fires."""

    def __init__(self, point: str, hit: int):
        self.point = point
        self.hit = int(hit)
        super().__init__(f"injected fault at {point!r} (hit #{hit})")


__all__ = [
    "OVF_OUT", "OVF_QUEUE", "OVF_PIECE", "OVF_ROUTE", "OVF_SEED",
    "ESCALATES_BATCH", "ESCALATES_OUT", "ESCALATES_ROUTE",
    "overflow_kinds", "ReproError", "CapacityOverflow", "WalError",
    "SnapshotError", "FaultInjected",
]
