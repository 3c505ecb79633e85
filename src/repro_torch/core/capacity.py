"""Ratcheting capacity hysteresis on a fixed geometric ladder (DESIGN.md §8).

Every device buffer in the repo is sized by ``pow2_capacity`` of its live
count, so a count oscillating around a power-of-two boundary flips the
buffer's static shape back and forth — and every flip is a fresh jit cache
entry (a *bucket flap*).  A :class:`Ratchet` removes the oscillation: per
buffer name it remembers the largest capacity ever granted and

- never shrinks (a count dropping back under the boundary keeps the old
  capacity, so the shape — and the compiled executable — is reused), and
- grows onto a *fixed canonical ladder*: rung ``r0 = pow2_capacity(1)``
  and ``r_{k+1} = r_k * factor``.  With ``factor=4`` the ladder is
  128, 512, 2048, 8192, ... — a quarter of the pow2 shapes, each rung
  with built-in headroom so a count creeping upward crosses few rungs.

The ladder is *history independent*: which rung a count lands on depends
only on the count, never on the path that got there.  That is what lets
``GraphSession.prewarm`` AOT-compile exactly the finite shape set the
runtime can ever request (:meth:`Ratchet.rungs` enumerates it) — a
slack-multiplied ladder would restart from arbitrary pow2 values after a
reset and make every pow2 shape reachable again.

:meth:`observe` floors a mark to a capacity that was actually built
(builders can exceed a request under shard skew) and is also how prewarm
*pins* delta/probe/seed marks to the update-batch bound, collapsing those
shapes to a single signature; pinned marks need not sit on canonical rungs.

Marks are plain host state; :meth:`reset` forgets selected names.  The
store resets its *committed-region* marks at compaction (those regions
drain to ~0 there, and holding them at the pre-compaction rung would make
every later fold pay O(threshold) instead of O(|Δ|) — the rungs it then
revisits are already in the jit cache, so re-walking the ladder costs no
compile).  Delta/probe/seed marks are never reset.
"""
from __future__ import annotations

from typing import Dict, Hashable, List

from repro_torch.core.csr import pow2_capacity

Key = Hashable


class Ratchet:
    """Monotone per-name capacity quantizer onto a fixed geometric ladder."""

    def __init__(self, factor: int = 4):
        if factor < 2 or (factor & (factor - 1)) != 0:
            raise ValueError("factor must be a power of two >= 2")
        self.factor = int(factor)
        self._caps: Dict[Key, int] = {}

    def quantize(self, n: int) -> int:
        """Smallest canonical rung >= ``n`` (128, 128*f, 128*f^2, ...)."""
        n = max(int(n), 1)
        r = pow2_capacity(1)
        while r < n:
            r *= self.factor
        return r

    def capacity(self, name: Key, n: int) -> int:
        """The capacity to build ``name`` at for live count ``n``.

        Returns the stored mark while ``n`` fits it; an overflow quantizes
        onto the canonical ladder and ratchets the mark up.  The result
        never decreases for a given name."""
        n = max(int(n), 1)
        cap = self._caps.get(name, 0)
        if n > cap:
            cap = max(self.quantize(n), cap)
            self._caps[name] = cap
        return cap

    def observe(self, name: Key, cap: int) -> None:
        """Floor ``name``'s mark to a capacity that was actually built.

        Builders may exceed the requested capacity (``build_sharded_index``
        rounds to the largest shard under skew); feeding the real capacity
        back keeps the ratchet — and the prewarm ladder — in sync with the
        shapes the jit cache will actually see.  Also the pinning primitive:
        prewarm observes delta/probe/seed marks at their update-batch bound
        so those buffers keep ONE shape for the life of the stream."""
        cap = int(cap)
        if cap > self._caps.get(name, 0):
            self._caps[name] = cap

    def peek(self, name: Key, default: int = 0) -> int:
        """Current mark without growing it (``default`` if never sighted)."""
        return self._caps.get(name, default)

    def reset(self, *names: Key) -> None:
        """Forget marks (all of them when called with no names)."""
        if not names:
            self._caps.clear()
            return
        for name in names:
            self._caps.pop(name, None)

    def next_rung(self, cap: int) -> int:
        """The smallest canonical rung strictly above ``cap``."""
        r = self.quantize(cap)
        return r * self.factor if r <= int(cap) else r

    def escalate(self, name: Key, floor: int = 0) -> int:
        """Bump ``name``'s mark to the next canonical rung above
        ``max(mark, floor)`` and return it — the overflow-recovery
        primitive (DESIGN.md §10): a
        :class:`~repro_torch.errors.CapacityOverflow` names the buffer
        that overflowed, the driver escalates its rung and replays the
        staged epoch.
        Monotone like every other mark mutation, so escalations persist
        through snapshot/restore and never flap."""
        cur = max(self._caps.get(name, 0), int(floor))
        new = self.next_rung(cur) if cur > 0 else self.quantize(1)
        self._caps[name] = max(new, cur)
        return self._caps[name]

    def rungs(self, lo: int, hi: int) -> List[int]:
        """Canonical rungs covering counts in ``[lo, hi]`` — the AOT
        prewarm ladder.  History independent: every capacity any mark can
        take for a count in range appears here."""
        r = self.quantize(lo)
        hi_cap = self.quantize(max(int(hi), int(lo), 1))
        out = [r]
        while r < hi_cap:
            r *= self.factor
            out.append(r)
        return out

    def marks(self) -> Dict[Key, int]:
        """Copy of the current marks (introspection/tests)."""
        return dict(self._caps)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Ratchet(factor={self.factor}, {len(self._caps)} marks)"
