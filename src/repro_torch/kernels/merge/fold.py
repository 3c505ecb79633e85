"""The per-relation epoch commit fold, both outputs in one kernel call:

    cins' = (cins \\ udel) ∪ (uins \\ cdel)
    cdel' = cdel ∪ (udel ∩ base)

Replaces the TPU kernel ``src/repro/kernels/merge/fold.py``
(``make_fold_kernel(composite)`` / ``_fold_call`` / ``commit_fold``),
1-word and composite (hi, lo) keys.
The CUDA kernel is ``csrc/fold.cu``: keep-mask probes, a multi-block scan,
and a scatter to merge positions; it is bound by reading the four regions
and writing both outputs (see the source note there).  The plain version
is the five-fold rank chain of the reference store
(``_commit_fold_ref``).  ``base`` enters only as ``in_ba``, the membership
bits of udel's rows in base, which the caller computes with the plain
fixed-depth search.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.core import csr
from repro_torch.core.csr import IndexData
from repro_torch.kernels import _build, count_launch


def _commit_fold_ref(cins: IndexData, cdel: IndexData, uins: IndexData,
                     udel: IndexData, in_ba: torch.Tensor, cins_cap: int,
                     cdel_cap: int):
    """The five-fold chain, plain searches only (runs on any device)."""
    kept = csr._select_core(cins, udel, cins.capacity, False, plain=True)
    fresh = csr._select_core(uins, cdel, uins.capacity, False, plain=True)
    new_cins = csr._merge_core(kept, fresh, cins_cap, plain=True)
    # dead = udel ∩ base, from the precomputed in_ba bits
    live = torch.arange(udel.capacity, dtype=torch.int32,
                        device=udel.device) < udel.n
    keep = live & (in_ba != 0)
    k = keep.to(torch.int32)
    cum = torch.cumsum(k, 0, dtype=torch.int32)
    pos = torch.where(keep, cum - 1, udel.capacity)
    dk, dv, dl = csr._empty_like_caps(udel.key.dtype, udel.capacity,
                                      udel.device, udel.lo is not None)
    csr._scatter_drop(dk, pos, udel.key)
    csr._scatter_drop(dv, pos, udel.val)
    if dl is not None:
        csr._scatter_drop(dl, pos, udel.lo)
    dead = IndexData(dk, dv, k.sum(dtype=torch.int32), dl)
    new_cdel = csr._merge_core(cdel, dead, cdel_cap, plain=True)
    return new_cins, new_cdel


def commit_fold(cins: IndexData, cdel: IndexData, uins: IndexData,
                udel: IndexData, in_ba: torch.Tensor, *, cins_cap: int,
                cdel_cap: int):
    """(cins', cdel') of one epoch; ``in_ba`` int32/bool [cap_udel]."""
    in_ba = in_ba.to(torch.int32)
    if not cins.key.is_cuda:
        return _commit_fold_ref(cins, cdel, uins, udel, in_ba, cins_cap,
                                cdel_cap)
    return _launch(cins, cdel, uins, udel, in_ba, cins_cap, cdel_cap)


def _launch(cins, cdel, uins, udel, in_ba, cins_cap, cdel_cap):
    regions = (cins, cdel, uins, udel)
    kd = cins.key.dtype
    if any(r.key.dtype != kd for r in regions):
        raise ValueError("commit_fold regions must share one key dtype")
    composite = _build.uniform_lo(regions)
    regions = tuple(SimpleNamespace(
        key=r.key.contiguous(), val=r.val.contiguous(),
        n=r.n.to(torch.int32),
        lo=None if r.lo is None else r.lo.contiguous()) for r in regions)
    in_ba = in_ba.contiguous()
    _build.require_cuda(in_ba)
    dev = cins.key.device
    lib = _build.lib("fold")
    scratch = torch.empty(
        lib.repro_commit_fold_scratch(cins.capacity, uins.capacity,
                                      udel.capacity),
        dtype=torch.int32, device=dev)
    def out(cap):
        cap = int(cap)
        return (torch.empty(cap, dtype=kd, device=dev),
                torch.empty(cap, dtype=torch.int32, device=dev),
                torch.empty(cap, dtype=torch.int64, device=dev)
                if composite else None,
                torch.empty((), dtype=torch.int32, device=dev))

    oci_k, oci_v, oci_l, oci_n = out(cins_cap)
    ocd_k, ocd_v, ocd_l, ocd_n = out(cdel_cap)
    p = _build.ptr
    rc = lib.repro_commit_fold(
        _build.region_desc(regions), p(in_ba), p(scratch), p(oci_k),
        p(oci_v), p(oci_l), p(oci_n), int(cins_cap), p(ocd_k), p(ocd_v),
        p(ocd_l), p(ocd_n), int(cdel_cap), _build.stream_of(oci_k))
    _build.check("fold", rc)
    count_launch("commit_fold_lex" if composite else "commit_fold")
    return (IndexData(oci_k, oci_v, oci_n, oci_l),
            IndexData(ocd_k, ocd_v, ocd_n, ocd_l))
