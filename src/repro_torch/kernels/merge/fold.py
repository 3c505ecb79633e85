"""The per-relation epoch commit fold, both outputs in one kernel launch:

    cins' = (cins \\ udel) ∪ (uins \\ cdel)
    cdel' = cdel ∪ (udel ∩ base)

Replaces the TPU kernel ``src/repro/kernels/merge/fold.py``
(``make_fold_kernel(composite)`` / ``_fold_call`` / ``commit_fold``),
1-word and composite (hi, lo) keys.
The CUDA kernel is ``csrc/fold.cu``: one cooperative launch a call (keep
bits packed by ballots, the chunk sums scanned in every block after a grid
barrier, a scatter to merge positions); see the source note there.

Two forms, exactly one of ``in_ba`` and ``base`` given:

* ``in_ba``, the TPU kernel's own function: the membership bits of udel's
  rows in base, computed by the caller;
* ``base``: the kernel probes base itself, in the same launch (the TPU
  kernel kept base out of VMEM; on the card it is read from device memory
  like the other regions).  ``base`` must share the four regions' key
  width and layout: a CUDA call refuses any other, where the plain version
  casts the probes to base's key dtype as ``csr.index_ranks`` does.

The plain versions are the five-fold rank chain of the reference store
(``_commit_fold_ref``), behind the fixed-depth rank probe of base for the
base form (``_commit_fold_base_ref``).

``sharded=True`` is the worker axis of the mesh's store (the TPU kernel's
``sharded=True``, ``grid=(w,)``): every region carries a leading [w] axis
(``[w, cap]``, counts ``[w]``) and ONE launch folds every worker's shard,
each from its own regions only, into ``[w, cins_cap]`` / ``[w, cdel_cap]``
outputs with ``[w]`` counts.  Only the base form has it (the ``in_ba``
form stays one region, and its sharded use raises ``ValueError``).  A
sharded launch counts under ``commit_fold_w`` / ``commit_fold_lex_w``; its
plain version is the one-region plain version a worker at a time,
stacked.
"""
from __future__ import annotations

from typing import Dict, Optional

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


def base_bits(base: IndexData, udel: IndexData) -> torch.Tensor:
    """``in_ba`` of the plain version: udel's rows in base, int32 [cap],
    through the plain fixed-depth rank search."""
    lt, le = csr.index_ranks(base, csr._qcols_of(udel), udel.val,
                             plain=True)
    return (le > lt).to(torch.int32)


def _commit_fold_base_ref(cins: IndexData, cdel: IndexData, uins: IndexData,
                          udel: IndexData, base: IndexData, cins_cap: int,
                          cdel_cap: int):
    """The base form's plain version: the rank probe of base, then the
    chain (runs on any device)."""
    return _commit_fold_ref(cins, cdel, uins, udel, base_bits(base, udel),
                            cins_cap, cdel_cap)


def _commit_fold_sharded_ref(cins, cdel, uins, udel, base, cins_cap,
                             cdel_cap):
    """The worker axis's plain version: the base form's a worker at a
    time, stacked (runs on any device)."""
    sv = csr.shard_view
    outs = [_commit_fold_base_ref(sv(cins, k), sv(cdel, k), sv(uins, k),
                                  sv(udel, k), sv(base, k), cins_cap,
                                  cdel_cap)
            for k in range(cins.key.shape[0])]
    return (csr.stack_shards(o[0] for o in outs),
            csr.stack_shards(o[1] for o in outs))


def commit_fold(cins: IndexData, cdel: IndexData, uins: IndexData,
                udel: IndexData, in_ba: Optional[torch.Tensor] = None, *,
                base: Optional[IndexData] = None, cins_cap: int,
                cdel_cap: int, sharded: bool = False):
    """(cins', cdel') of one epoch, from ``in_ba`` (int32/bool
    [cap_udel], udel's rows in base) or from ``base`` itself; with
    ``sharded`` every region carries a leading [w] worker axis (the base
    form only)."""
    if (in_ba is None) == (base is None):
        raise ValueError("commit_fold takes exactly one of in_ba and base")
    if sharded:
        if base is None:
            raise ValueError("the sharded commit fold takes base, not "
                             "in_ba (the in_ba form is one region)")
        if not cins.key.is_cuda:
            return _commit_fold_sharded_ref(cins, cdel, uins, udel, base,
                                            int(cins_cap), int(cdel_cap))
        return _launch_w(cins, cdel, uins, udel, base, int(cins_cap),
                         int(cdel_cap))
    if not cins.key.is_cuda:
        if base is not None:
            return _commit_fold_base_ref(cins, cdel, uins, udel, base,
                                         cins_cap, cdel_cap)
        return _commit_fold_ref(cins, cdel, uins, udel,
                                in_ba.to(torch.int32), cins_cap, cdel_cap)
    return _launch(cins, cdel, uins, udel, in_ba, base, int(cins_cap),
                   int(cdel_cap))


# (key dtype, composite, the four regions' capacities, cins_cap, cdel_cap,
# workers) -> the int64 words of the one allocation and its offsets
_LAYOUTS: Dict[tuple, tuple] = {}


def _layout(lib, kd, composite, caps, cins_cap, cdel_cap, w=0):
    """Both outputs and the kernel's scratch carved from one int64
    allocation: int64 keys and the lo words first (in int64 words), then
    in int32 words int32 keys, both vals, both counts and the scratch
    (8-byte aligned).  ``w`` > 0 gives every output a leading [w] axis
    (counts [w]) and the scratch of w workers.  Returns (words, ((key,
    val, lo, n) of cins', the same of cdel'), scratch), each offset in its
    dtype's units."""
    key = (kd, composite, caps, cins_cap, cdel_cap, w)
    got = _LAYOUTS.get(key)
    if got is not None:
        return got
    m = max(w, 1)
    wide = kd == torch.int64
    w64 = 0
    outs = []
    for cap in (cins_cap, cdel_cap):
        k = lo = None
        if wide:
            k, w64 = w64, w64 + m * cap
        if composite:
            lo, w64 = w64, w64 + m * cap
        outs.append([k, None, lo, None, cap])
    w32 = 2 * w64
    for o in outs:
        if not wide:
            o[0], w32 = w32, w32 + m * o[4]
        o[1], w32 = w32, w32 + m * o[4]
    for o in outs:
        o[3], w32 = w32, w32 + m
    scratch = w32 + (w32 & 1)
    w32 = scratch + (lib.repro_commit_fold_scratch_w(*caps, w) if w
                     else lib.repro_commit_fold_scratch(*caps))
    got = ((w32 + 1) // 2, tuple(tuple(o[:4]) for o in outs), scratch)
    _LAYOUTS[key] = got
    return got


def _outputs(buf, outs, caps, wide, w=0):
    """The output IndexData views of one allocation, and the pointer
    arguments of both outputs ((key, val, lo, n, cap) each)."""
    b32 = buf.view(torch.int32)
    at = buf.data_ptr()
    views, ptrs = [], []
    for (k, v, lo, n), cap in zip(outs, caps):
        kb = buf if wide else b32
        shape, stride = ((w, cap), (cap, 1)) if w else ((cap,), (1,))
        nshape = ((w,), (1,)) if w else ((), ())
        views.append(IndexData(
            kb.as_strided(shape, stride, k), b32.as_strided(shape, stride, v),
            b32.as_strided(*nshape, n),
            None if lo is None else buf.as_strided(shape, stride, lo)))
        ptrs += [at + k * (8 if wide else 4), at + 4 * v,
                 0 if lo is None else at + 8 * lo, at + 4 * n, cap]
    return views, ptrs


def _launch(cins, cdel, uins, udel, in_ba, base, cins_cap, cdel_cap):
    regions = (cins, cdel, uins, udel) if base is None else \
        (cins, cdel, uins, udel, base)
    kd, composite = cins.key.dtype, cins.lo is not None
    for r in regions:
        if r.key.dtype != kd or (r.lo is not None) != composite:
            raise ValueError("commit_fold regions (base included) must "
                             "share one key dtype and layout (composite "
                             "or not)")
    desc = _build.region_desc(regions)
    lib = _build.lib("fold")
    words, outs, scratch = _layout(
        lib, kd, composite, (cins.key.shape[0], cdel.key.shape[0],
                             uins.key.shape[0], udel.key.shape[0]),
        cins_cap, cdel_cap)
    buf = torch.empty(words, dtype=torch.int64, device=cins.key.device)
    at = buf.data_ptr()
    views, ptrs = _outputs(buf, outs, (cins_cap, cdel_cap),
                           kd == torch.int64)
    if in_ba is not None:
        if in_ba.dtype != torch.int32:
            in_ba = in_ba.to(torch.int32)
        _build.require_cuda(in_ba)
        if in_ba.shape[0] < udel.capacity:
            raise ValueError("in_ba covers udel's capacity")
    rc = lib.repro_commit_fold(desc, len(regions), _build.ptr(in_ba),
                               at + 4 * scratch, *ptrs,
                               _build.stream_of(buf))
    _build.check("fold", rc)
    count_launch("commit_fold_lex" if composite else "commit_fold")
    return views[0], views[1]


def _launch_w(cins, cdel, uins, udel, base, cins_cap, cdel_cap):
    """One launch over every worker's shard of the five regions."""
    regions = (cins, cdel, uins, udel, base)
    kd, composite = cins.key.dtype, cins.lo is not None
    w = cins.key.shape[0]
    for r in regions:
        if r.key.dtype != kd or (r.lo is not None) != composite:
            raise ValueError("commit_fold regions (base included) must "
                             "share one key dtype and layout (composite "
                             "or not)")
        parts = (r.key, r.val) + (() if r.lo is None else (r.lo,))
        if r.key.dim() != 2 or r.key.shape[0] != w or \
                tuple(r.n.shape) != (w,) or \
                any(t.shape != r.key.shape for t in parts):
            raise ValueError(f"sharded regions are [w, cap] with counts "
                             f"[w], w = {w} for all five")
        _build.require_cuda(*parts, r.n)
    desc = _build.region_desc([csr.shard_view(r, 0) for r in regions])
    lib = _build.lib("fold")
    words, outs, scratch = _layout(
        lib, kd, composite, (cins.key.shape[1], cdel.key.shape[1],
                             uins.key.shape[1], udel.key.shape[1]),
        cins_cap, cdel_cap, w)
    buf = torch.empty(words, dtype=torch.int64, device=cins.key.device)
    views, ptrs = _outputs(buf, outs, (cins_cap, cdel_cap),
                           kd == torch.int64, w)
    rc = lib.repro_commit_fold_w(desc, len(regions), w,
                                 buf.data_ptr() + 4 * scratch, *ptrs,
                                 _build.stream_of(buf))
    _build.check("fold", rc)
    count_launch("commit_fold_lex_w" if composite else "commit_fold_w")
    return views[0], views[1]
