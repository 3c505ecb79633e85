"""Versioned extension indices for the BiGJoin dataflow.

A :class:`VersionedIndex` is the multi-region structure of §4.3 flattened to
tensors: *positive* regions contribute extensions (compacted base, committed
inserts, uncommitted inserts) and *negative* regions subtract membership
(committed / uncommitted deletes):

    static:  pos=(base,)                 neg=()
    old:     pos=(base, cins)            neg=(cdel,)
    new:     pos=(base, cins, uins)      neg=(cdel, udel)

Counts and proposals come from positive regions only; deletions are applied
as signed membership.  Membership of every region goes through the
multi-region kernel wrapper in one call.  A probe key is one tensor, or the
(hi, lo) pair when the regions are composite (3-4 bound columns).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.csr import (IndexData, PackedKey, index_range,
                                  shard_view)
from repro_torch.kernels.intersect.ops import signed_member


@dataclasses.dataclass
class VersionedIndex:
    pos: Tuple[IndexData, ...]
    neg: Tuple[IndexData, ...]

    @classmethod
    def static(cls, data: IndexData) -> "VersionedIndex":
        return cls((data,), ())

    def worker_shard(self, i: int = 0) -> "VersionedIndex":
        """Worker ``i``'s slice of a sharded index whose regions carry a
        leading [w] worker axis (``csr.build_sharded_index``): views, no
        copy.  The mesh's owners answer their requests from it."""
        return VersionedIndex(tuple(shard_view(p, i) for p in self.pos),
                              tuple(shard_view(n, i) for n in self.neg))

    def live_entries(self) -> int:
        """Total live rows over every region (and every worker shard)."""
        return int(sum(int(d.n.sum()) for d in self.pos + self.neg))

    # ---- queries (vectorized over probe batch [B]) ------------------------

    def ranges(self, qkey: PackedKey
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(starts [B,R], counts [B,R]) over positive regions."""
        ss, cs = [], []
        for reg in self.pos:
            s, c = index_range(reg, qkey)
            ss.append(s)
            cs.append(c)
        return torch.stack(ss, -1), torch.stack(cs, -1)

    def count(self, qkey: PackedKey) -> torch.Tensor:
        """Positive-region extension count [B] (exact when no deletions)."""
        _, c = self.ranges(qkey)
        return c.sum(-1, dtype=torch.int32)

    def gather(self, starts: torch.Tensor, counts: torch.Tensor,
               k: torch.Tensor) -> torch.Tensor:
        """k-th extension across concatenated positive regions
        (starts/counts: [B, R] rows gathered per probe; k: [B])."""
        val = torch.zeros(k.shape, dtype=torch.int32, device=k.device)
        off = k
        for r, reg in enumerate(self.pos):
            in_r = (off >= 0) & (off < counts[..., r])
            p = (starts[..., r] + off).clamp(0, reg.capacity - 1).long()
            val = torch.where(in_r, reg.val[p], val)
            off = off - counts[..., r]
        return val

    def signed_member(self, qkey: PackedKey, qval: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(membership, deletion) bits in ONE pass over all regions."""
        wpos, wneg = signed_member(self.pos, self.neg, qkey, qval)
        return (wpos - wneg) > 0, wneg > 0

    def member(self, qkey: PackedKey, qval: torch.Tensor) -> torch.Tensor:
        return self.signed_member(qkey, qval)[0]

    def deleted(self, qkey: PackedKey, qval: torch.Tensor
                ) -> torch.Tensor:
        if not self.neg:
            return torch.zeros(qval.shape, dtype=torch.bool,
                               device=qval.device)
        _, wneg = signed_member((), self.neg, qkey, qval)
        return wneg > 0
