#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order, each printed with its result and seconds:

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels  — every kernel of the streaming engine, 1-word and composite
              (hi, lo) variant, against its plain PyTorch version on the
              card at the main path's shapes (int32 and int64 hi words),
              exact equality, with the kernel's time (CUDA events around
              back-to-back calls, its device time from the profiler, and
              the host's time to enqueue one call, ``host_us``), the plain
              version's and one library call's time (events and device,
              labelled where it computes less than the kernel), and the
              least time the card could take (``bound_ms``); the
              membership kernels also at their edge inputs at full size
              (a 100,000-entry run of one key, n = 0, n = capacity,
              sentinel queries, queries past either end); then the
              flash-attention kernels against their plain version at the
              JAX package's six sweep shapes (f32 and bf16), at bf16 rows
              without a live key and a decode plan with masked chunks and
              chunks past the cache, and at gemma2-2b's serving shapes
              (bf16 prefill on the tensor-core kernel and decode split over
              the cache, local and global layers) with planted faults
              (an edge off by a key or a key tile, a decode chunk dropped)
              the check must reject, with compiled flex_attention's or
              scaled_dot_product_attention's time beside them;
4. verify   — a GraphSession over dirty update epochs, one cell per
              (scale, queries): each epoch's signed delta equal to the numpy
              oracle (full recomputation), compaction included.  A cell
              naming an n-ary query (``4-clique-tri``, ``5-clique-quad``)
              materialises its relation from the feeding query
              (``triangle``, ``4-clique``), feeds it that query's delta every
              epoch, and holds the n-ary query to its edge-only twin too;
5. serve    — the same session at realistic graph sizes, one cell per
              (scale, queries): warm per-epoch latency, peak device memory,
              each kernel's launch count (every kernel of the cell's path
              must launch) and the device idle share of one profiled warm
              epoch;
6. train driver — ``repro_torch.launch.train`` with --arch gatedgcn at its
              defaults to step 10, relaunched to step 20: it resumes from
              its checkpoint and ends with a finite loss;
7. train full — GatedGCN at full width (16 layers, d 70, the minibatch_lg
              shape) on a 232,965-node graph: triangle features from the
              port's BiGJoin on the card, sampled union graphs, the
              segment_sum kernel against its plain version at that shape
              (f32, f16, unsorted; random rows on the padding hub and all
              rows in one segment against float64; two calls bitwise
              equal), the first step against the host's, then
              6 steps: step ms, peak memory, idle share of a profiled step,
              2 segment_sum launches per layer and step;
8. train archs — one step of each GNN arch at smoke width and of a
              graph_reg batch, the card's loss against the host's;
9. lm verify — the LM transformer on the card against the host, f32 on
              both: the yi-34b, gemma-7b and gemma2-2b smoke configs
              (forward, loss, prefill, 4 decode steps) and gemma2-2b at
              full width and depth 2 on a 4,160-token request;
10. lm serve gemma2-2b — full width and depth, bf16, random parameters
              from the seed: 4 prompts of 8,192 tokens, prefill and 32
              greedy decode steps, 3 rounds (1 cold) and one profiled
              prefill and decode step; decode held against prefill; 26
              flash launches per prefill and per decode step.

The second-to-last lines are the kernel table as one JSON object and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
non-zero and no result line is printed.  Needs one CUDA device; run from the
repository root: ``python3 chip_smoke.py [--serve 16:triangle,diamond@10]``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# the composite kernels' relations: the triangles of R-MAT scale 14 (the
# tri serve cell's 4,506,715 tuples) and random 4-column rows as many as
# the 4-cliques of R-MAT scale 12 (rmat_graph seed 0, edge factor 16)
TRI_SCALE = 14
QUAD_ROWS = 14_599_324


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator-free phase timer: ``with phase("x"):`` prints seconds."""
    class _P:
        def __enter__(self):
            self.t = time.time()
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                log(f"phase {name}: ok ({time.time() - self.t:.2f} s)")
            return False
    return _P()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def sync() -> None:
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = SCALAR_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the card's peak rate for their type (the scalar rate
    unless given)."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    o = ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def depth(cap: int) -> int:
    return max(int(np.ceil(np.log2(max(cap, 2)))), 1)


def entry_bytes(idx) -> int:
    """Bytes of one entry: key, the composite lo word, val."""
    return idx.key.element_size() + 4 + (8 if idx.lo is not None else 0)


def search_bytes(idx, searches: int) -> float:
    """Index bytes a batch of binary searches over the live prefix must
    read (data-dependent count): the top floor(log2 searches) levels of the
    search tree, which every search shares, once; below them each search's
    own probes; never more than the live entries."""
    live = int(idx.n)
    if searches <= 0 or live == 0:
        return 0.0
    d = depth(max(live, 2))
    shared = min(int(np.log2(searches)), d)
    entries = (1 << shared) - 1 + searches * (d - shared)
    return min(live, entries) * entry_bytes(idx)


# the CUDA kernels each wrapper launches, by the names the profiler shows
KERNEL_FUNCS = {
    "signed_member": ("signed_member_kernel",),
    "member": ("signed_member_kernel",),
    "segment_sum": ("segsum_rows", "segsum_level"),
    # bf16 prefill (tensor cores), decode split and combine, f32 prefill
    "flash_attention": ("flash_prefill", "flash_decode_split",
                        "flash_decode_combine", "flash_kernel"),
    "fused_extend": ("extend_count", "extend_budget", "extend_propose"),
    "rank_lt_le": ("rank_kernel",),
    "commit_fold": ("fold_masks", "scan_tiles", "scan_tile_sums",
                    "scan_apply", "fold_scatter"),
}


def _device_events(prof):
    """(name, microseconds, start, end) of every activity the profiler
    recorded on the card, read from the raw Kineto records: building the
    profiler's FunctionEvents for an epoch of 20,000 launches took minutes
    on the chip machine's host."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA":
            a = ev.start_ns() / 1e3
            b = a + ev.duration_ns() / 1e3
            out.append((ev.name(), b - a, a, b))
    return out


def device_ms(fn, reps: int, kernel: str, names=None, seen=None,
              per_call=None):
    """The card's own time for one call: for each CUDA kernel the wrapper
    launches (``names``, by default all of KERNEL_FUNCS[kernel]), the
    mean duration of its launches that ``torch.profiler`` recorded over
    ``reps`` calls, times its launches a call (``per_call``, 1 unless
    given), summed over those kernels.  The profiler on that machine
    loses some records now and then (whole sessions of them once Triton
    has launched a kernel in the process): a session that lost any is
    retried, up to six in all, and the most complete one kept, its mean
    over the recorded launches standing in for the lost ones (the log
    says how many were recorded); None when a kernel has no record at
    all.  A ``seen`` set receives the names of every kernel recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = names or KERNEL_FUNCS[kernel.removesuffix("_lex")]
    per_call = {n: (per_call or {}).get(n, 1) for n in names}
    want = reps * sum(per_call.values())
    best, best_got = None, 0
    for _attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = {n: [] for n in names}
        for name, us, _a, _b in _device_events(prof):
            if seen is not None:
                seen.add(name)
            for n in names:
                if n in name:
                    durs[n].append(us)
        got = sum(len(d) for d in durs.values())
        if not all(durs.values()):
            log(f"  {kernel}: the profiler recorded no launch of "
                f"{[n for n, d in durs.items() if not d]}")
            continue
        if got > best_got:
            best, best_got = durs, got
        if got >= want:
            break
    if best is None:
        return None
    if best_got < want:
        log(f"  {kernel}: the profiler recorded {best_got} of {want} "
            f"launches")
    return sum(float(np.mean(d)) * per_call[n]
               for n, d in best.items()) / 1e3


def library_device_ms(fn, reps: int, label: str):
    """The card's own time for one library call: for every activity name
    ``torch.profiler`` recorded on the card over ``reps`` calls (kernels,
    copies, fills, whatever the call launches; the names go to the log),
    the mean duration of its records times its launches a call, summed.
    A call's launches of a name are its records over ``reps``, rounded
    up: the profiler loses records now and then (see device_ms), so a
    session whose counts are not whole multiples of ``reps`` is retried,
    and the last one kept; None when no session has any record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for _attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = {}
        for name, us, _a, _b in _device_events(prof):
            durs.setdefault(name[:60], []).append(us)
        if not durs:
            log(f"  {label}: the profiler recorded nothing")
            continue
        best = durs
        whole = all(len(d) % reps == 0 for d in durs.values())
        log(f"  {label}: records over {reps} calls "
            f"{ {n: len(d) for n, d in durs.items()} }"
            f"{'' if whole else ' (some lost)'}")
        if whole:
            break
    if best is None:
        return None
    return sum(float(np.mean(d)) * -(-len(d) // reps)
               for d in best.values()) / 1e3


def host_us(fn, reps: int) -> float:
    """The host's time to enqueue one call, in microseconds: five runs of
    ``reps`` back-to-back calls with no synchronise between them, the
    median run over ``reps`` (the host is shared, so single runs
    spread).  With the card busier than the host this is the wrapper's own
    cost; a queue that fills would make it wait for the card."""
    fn()
    sync()
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append(time.perf_counter() - t)
        sync()
    return float(np.median(runs)) / reps * 1e6


def idle_share(fn, by_name=None, per_call=None):
    """Run ``fn`` once under the profiler (CUDA activity only): (host
    seconds, device busy seconds, idle share, recorded launches of the
    port's kernels, their launches by the wrappers' counts) of that window,
    busy time being the union of every kernel and copy interval recorded on
    the card.  Where the profiler lost records the busy time is a lower
    bound.  A ``by_name`` dict receives each recorded activity's name
    (cut to 80 characters) -> (launches, total milliseconds).
    ``per_call`` overrides the CUDA launches per wrapper call of a kernel
    (all of its KERNEL_FUNCS by default; flash_attention's route decides:
    1 for a prefill, 2 for a decode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    per_call = {**{k: len(v) for k, v in KERNEL_FUNCS.items()},
                **(per_call or {})}
    before = kernels.launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    after = kernels.launches()
    expected = sum((after[k] - before[k]) * per_call[k.removesuffix("_lex")]
                   for k in after)
    evs = _device_events(prof)
    if by_name is not None:
        for name, us, _a, _b in evs:
            n, ms = by_name.get(name[:80], (0, 0.0))
            by_name[name[:80]] = (n + 1, ms + us / 1e3)
    ours = sum(1 for name, *_ in evs
               if any(n in name for v in KERNEL_FUNCS.values() for n in v))
    spans = sorted((a, b) for _n, _us, a, b in evs)
    busy, end = 0.0, None
    for a, b in spans:  # union of intervals, in microseconds
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy / 1e6
    idle = max(0.0, 1.0 - busy_s / wall) if spans else None
    return wall, busy_s, idle, ours, expected


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output; raises on any
    difference in dtype, shape or bits."""
    import torch
    err = 0
    for g, w in zip(got, want):
        if hasattr(g, "key"):  # IndexData
            if (g.lo is None) != (w.lo is None):
                raise AssertionError("composite lo word present in one "
                                     "output only")
            g = (g.key, g.val, g.n) + (() if g.lo is None else (g.lo,))
            w = (w.key, w.val, w.n) + (() if w.lo is None else (w.lo,))
        else:
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"dtype/shape {a.dtype}{tuple(a.shape)}"
                                     f" != {b.dtype}{tuple(b.shape)}")
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
    if err:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max |err| = {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def recorder(results: dict):
    """``record(...)`` for one variant of a kernel: the table keeps the
    times of the variant the main path runs most (``main``), and the
    largest error over all variants.  ``library`` names what the library
    call computes where it is not the kernel's whole function."""
    def record(name, err, ms, dev_ms, plain_ms, bytes_moved, ops,
               library_ms, shape, main, ops_per_s=SCALAR_OPS_PER_S,
               library_device_ms=None, host=None, library=None):
        b_ms, b_by = bound(bytes_moved, ops, ops_per_s)
        row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                   library_device_ms=library_device_ms, host_us=host,
                   library=library, shape=shape)

        def num(x, fmt):
            return "null" if x is None else format(x, fmt)
        log(f"  {name} [{shape}] ms={ms:.4f} device_ms={num(dev_ms, '.4f')}"
            f" host_us={num(host, '.2f')} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms="
            f"{num(library_ms, '.4f')} library_device_ms="
            f"{num(library_device_ms, '.4f')}"
            f"{f' ({library})' if library else ''} max_abs_err={err}")
        entry = results.setdefault(name, dict(max_abs_err=0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(row)
    return record


def member_edge_checks(big, rows: np.ndarray, narrow: bool, label: str,
                       seed: int) -> None:
    """The membership kernels at their edge cases, full size, against
    their plain versions exactly: ``big``, a main-path region of more than
    33^2 live entries keyed on all but the last column of ``rows`` (1-word
    for 2 columns, composite (hi, lo) for 4); beside it a region whose
    first 100,000 entries share one key with distinct vals, one whose live
    count equals its capacity (2^20), and one with n = 0.  Queries: live
    rows of each, the long run's key with vals past it, random rows,
    all-sentinel queries, queries below the first entry and above the
    last.  signed_member over 3+2 and 1+1 regions, member over each
    region."""
    import torch
    from repro_torch.core import csr
    from repro_torch.core.csr import IndexData
    from repro_torch.kernels.intersect import ops as iops, ref as iref
    dev = big.key.device
    rng = np.random.default_rng(seed + 29)
    ar = rows.shape[1]
    cols = tuple(range(ar - 1))
    nv = int(rows.max()) + 1
    run_len, full_n = 100_000, 1 << 20

    def build(r, cap=None):
        return csr.build_index(r, cols, ar - 1, capacity=cap, narrow=narrow,
                               device=dev)

    run_rows = rng.integers(0, nv, (full_n, ar)).astype(np.int32)
    run_rows[:run_len, :ar - 1] = run_rows[0, :ar - 1]
    run_rows[:run_len, ar - 1] = np.arange(run_len)
    run = build(run_rows)
    full_rows = np.unique(rng.integers(0, max(nv, 4096), (
        full_n + full_n // 4, ar)).astype(np.int32), axis=0)[:full_n]
    full = build(full_rows, full_n)
    if int(full.n) != full.capacity:
        raise AssertionError(f"{label}: n {int(full.n)} != cap "
                             f"{full.capacity}")
    empty = IndexData(run.key, run.val,
                      torch.zeros((), dtype=torch.int32, device=dev), run.lo)
    kd = np.int64 if big.key.dtype == torch.int64 else np.int32
    sample = [r[rng.integers(0, r.shape[0], 4096)]
              for r in (rows, run_rows[:run_len], full_rows)]
    misses = run_rows[:2048].copy()
    misses[:, ar - 1] = run_len + np.arange(2048)
    q = np.concatenate(sample + [misses, rng.integers(
        0, nv + 2, (4096, ar)).astype(np.int32)])
    if ar == 2:
        qh, ql = q[:, 0].astype(np.int64), None
    else:
        qh, ql = csr.pack_key(tuple(q[:, c] for c in cols))
    qv = q[:, ar - 1].astype(np.int32)
    # sentinel, below the first entry, above the last, in the key's dtype
    imax, imin = np.iinfo(kd).max, np.iinfo(kd).min
    lmax, lmin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    top = int(big.key[int(big.n) - 1])
    sh = np.array([imax, imax, imax, imin, -1, top + 1, top, imax - 1])
    sv = np.array([2**31 - 1, 0, 2**31 - 1, -2**31, 0, 0, 2**31 - 1, 0],
                  np.int32)
    qh = np.concatenate([qh.astype(kd), sh.astype(kd),
                         np.full(64, imax, kd)])
    qv = np.concatenate([qv, sv, np.full(64, 2**31 - 1, np.int32)])
    tq = torch.from_numpy(qh).to(dev)
    tv = torch.from_numpy(qv).to(dev)
    tl = None
    if ql is not None:
        sl = np.array([lmax, 0, lmax, lmin, 0, 0, lmax, lmax])
        tl = torch.from_numpy(np.concatenate(
            [ql.astype(np.int64), sl, np.full(64, lmax)])).to(dev)
    qk = tq if tl is None else (tq, tl)
    hits = {}
    for what, pos, neg in (("3+2", [big, run, full], [empty, run]),
                           ("1+1", [empty], [full])):
        got = iops.signed_member(pos, neg, qk, tv)
        want = iref.signed_member_ref(pos, neg, qk, tv)
        sync()
        max_abs_err(got, want)
        hits[f"signed {what}"] = [int(w.sum()) for w in want]
    for what, r in (("big", big), ("run", run), ("n=cap", full),
                    ("n=0", empty)):
        got = iops.member(r.key, r.val, r.n, tq, tv, los=r.lo, ql=tl)
        want = iref.member_ref(r.key, r.val, r.n, tq, tv, los=r.lo, ql=tl)
        sync()
        max_abs_err((got,), (want,))
        hits[f"member {what}"] = int(want.sum())
    log(f"  membership edge cases {label}: {tq.shape[0]} queries, big n="
        f"{int(big.n)}, run of {run_len} on one key, n=cap={full_n}, n=0: "
        f"exact; hits {hits}")


def kernel_phase(edges: np.ndarray, nv: int, update_batch: int,
                 committed: int, reps: int, seed: int) -> dict:
    import torch
    from repro_torch.core import csr
    from repro_torch.core.delta import _packed_index
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.kernels.extend import ops as eops, ref as eref
    from repro_torch.kernels.intersect import ops as iops, ref as iref
    from repro_torch.kernels.merge import fold as mfold
    from repro_torch.kernels.merge import ops as mops, ref as mref

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    stream = EdgeUpdateStream(nv, update_batch, seed=seed)
    upd, w = stream.batch_at(0, edges)
    ins = upd[w > 0]
    ins = ins[ins[:, 0] != ins[:, 1]]
    dels = upd[w < 0][: update_batch // 4]
    fresh = rng.integers(0, nv, (committed, 2)).astype(np.int32)
    fresh = fresh[fresh[:, 0] != fresh[:, 1]]
    gone = edges[rng.integers(0, edges.shape[0], committed // 3)]
    cc = csr.pow2_capacity(committed)

    def proj(rows, narrow, cap=None):
        return csr.build_index(rows, (0,), 1, capacity=cap, narrow=narrow,
                               device=dev)

    def packed(rows, cap=None):
        return _packed_index(rows, dev, capacity=cap)

    results = {}

    record = recorder(results)

    def packed_words(idx):
        """(key<<32 | val) int64 words of the live entries (keys that
        already fill 64 bits carry val == 0 and stand alone)."""
        n = int(idx.n)
        k = idx.key[:n].to(torch.int64)
        if idx.key.dtype == torch.int64 and int(idx.val[:n].abs().max()
                                                if n else 0) == 0:
            return k
        return (k << 32) | idx.val[:n].to(torch.int64)

    for label, narrow in (("i64", False), ("i32", True)):
        base = packed(edges) if not narrow else proj(edges, True,
                                                     csr.pow2_capacity(
                                                         edges.shape[0]))
        if not narrow:  # the live set: (base, cins, uins | cdel, udel)
            regs = [base, packed(fresh, cc), packed(ins, update_batch)]
            negs = [packed(gone, cc), packed(dels, update_batch)]
            qrows = upd
            qk = torch.from_numpy((upd[:, 0].astype(np.int64) << 32)
                                  | upd[:, 1]).to(dev)
            qv = torch.zeros(qk.shape[0], dtype=torch.int32, device=dev)
        else:
            regs = [base, proj(fresh, True, cc), proj(ins, True,
                                                     update_batch)]
            negs = [proj(gone, True, cc), proj(dels, True, update_batch)]
            qrows = upd
            qk = torch.from_numpy(qrows[:, 0].copy()).to(dev)
            qv = torch.from_numpy(qrows[:, 1].copy()).to(dev)
        kb = regs[0].key.element_size()
        B = qk.shape[0]
        # -- signed membership: normalize probes the live set's "old"
        # version (base, cins | cdel); the int32 variant is a seed filter
        # over a projection's "new" version (all five regions)
        mregs, mnegs = (regs, negs) if narrow else (regs[:2], negs[:1])
        got = iops.signed_member(mregs, mnegs, qk, qv)
        want = iref.signed_member_ref(mregs, mnegs, qk, qv)
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: iops.signed_member(mregs, mnegs, qk, qv), reps)
        hus = host_us(lambda: iops.signed_member(mregs, mnegs, qk, qv), reps)
        dms = device_ms(lambda: iops.signed_member(mregs, mnegs, qk, qv),
                        reps, "signed_member")
        pms = cuda_ms(lambda: iref.signed_member_ref(mregs, mnegs, qk, qv),
                      max(reps // 10, 2))
        words = packed_words(regs[0])
        qwords = (qk.to(torch.int64) << 32 | qv.to(torch.int64)) \
            if narrow else qk

        def lib():
            return torch.searchsorted(words, qwords)
        lms = cuda_ms(lib, reps)
        ldms = library_device_ms(lib, reps, "torch.searchsorted")
        nbytes = B * (kb + 4) + 2 * 4 * B + sum(
            search_bytes(r, B) for r in mregs + mnegs)
        ops = B * sum(depth(max(int(r.n), 2)) for r in mregs + mnegs)
        nr = len(mregs) + len(mnegs)
        record("signed_member", err, ms, dms, pms, nbytes, ops, lms,
               f"{label} B={B} regions={len(mregs)}+{len(mnegs)} "
               f"cap={regs[0].capacity}", main=not narrow,
               library_device_ms=ldms, host=hus,
               library=f"torch.searchsorted over the base region's packed "
               f"live words: 1 of {nr} regions, no signed count")

        # -- single-region membership: the same queries against the live
        # set's base alone (the eager re-insertion probe's shape)
        if not narrow:
            b0 = regs[0]

            def mem_k():
                return iops.member(b0.key, b0.val, b0.n, qk, qv)

            def mem_p():
                return iref.member_ref(b0.key, b0.val, b0.n, qk, qv)

            got, want = mem_k(), mem_p()
            sync()
            err = max_abs_err((got,), (want,))
            ms = cuda_ms(mem_k, reps)
            hus = host_us(mem_k, reps)
            dms = device_ms(mem_k, reps, "member")
            pms = cuda_ms(mem_p, max(reps // 10, 2))

            def lib():
                return torch.isin(qk, words)
            lms = cuda_ms(lib, reps)
            ldms = library_device_ms(lib, reps, "torch.isin")
            nbytes = B * (kb + 4) + B + search_bytes(b0, B)
            ops = B * depth(max(int(b0.n), 2))
            record("member", err, ms, dms, pms, nbytes, ops, lms,
                   f"{label} B={B} region=1 cap={b0.capacity}", main=True,
                   library_device_ms=ldms, host=hus,
                   library="torch.isin over the packed live words")

        # -- merge ranks (compaction: every base entry against cdel) -------
        a = negs[0]
        q_key, q_val = base.key, base.val
        got = mops.rank_lt_le(a.key, a.val, a.n, q_key, q_val)
        want = mref.rank_ref(a.key, a.val, a.n, q_key, q_val)
        sync()
        err = max_abs_err(got, want)
        rreps = max(reps // 10, 3)

        def rank_k():
            return mops.rank_lt_le(a.key, a.val, a.n, q_key, q_val)
        ms = cuda_ms(rank_k, rreps)
        hus = host_us(rank_k, rreps)
        dms = device_ms(rank_k, rreps, "rank_lt_le")
        pms = cuda_ms(lambda: mref.rank_ref(a.key, a.val, a.n, q_key, q_val),
                      2)
        awords = packed_words(a)
        bq = (q_key.to(torch.int64) << 32 | q_val.to(torch.int64)) \
            if narrow else q_key

        def lib():  # both ranks, lt and le, as the kernel computes them
            return (torch.searchsorted(awords, bq),
                    torch.searchsorted(awords, bq, right=True))
        lms = cuda_ms(lib, rreps)
        ldms = library_device_ms(lib, rreps, "torch.searchsorted x2")
        Bq = q_key.shape[0]
        nbytes = Bq * (kb + 4) + 2 * 4 * Bq + search_bytes(a, 2 * Bq)
        ops = 2 * Bq * depth(max(int(a.n), 2))
        record("rank_lt_le", err, ms, dms, pms, nbytes, ops, lms,
               f"{label} B={Bq} cap={a.capacity} n={int(a.n)}",
               main=narrow, library_device_ms=ldms, host=hus,
               library="torch.searchsorted left and right, summed")

        # -- commit fold (projection or live set) --------------------------
        ci, cd, ui, ud = regs[1], negs[0], regs[2], negs[1]
        lt, le = csr.index_ranks(base, ud.key, ud.val, plain=True)
        in_ba = (le > lt).to(torch.int32)

        def fold_k():
            return mfold.commit_fold(ci, cd, ui, ud, in_ba, cins_cap=cc,
                                     cdel_cap=cc)

        def fold_p():
            return mfold._commit_fold_ref(ci, cd, ui, ud, in_ba, cc, cc)

        got, want = fold_k(), fold_p()
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(fold_k, reps)
        hus = host_us(fold_k, reps)
        dms = device_ms(fold_k, reps, "commit_fold")
        pms = cuda_ms(fold_p, max(reps // 10, 2))
        # the fold reads the live entries of its four regions and of in_ba,
        # and writes both outputs whole (their padding included)
        live = [int(r.n) for r in (ci, cd, ui, ud)]
        nbytes = sum(n * entry_bytes(r) + 4 for n, r in
                     zip(live, (ci, cd, ui, ud))) + 4 * live[3] \
            + 2 * cc * (kb + 4) + 8
        ops = sum(live) * 3 * depth(cc)
        record("commit_fold", err, ms, dms, pms, nbytes, ops, None,
               f"{label} caps={ci.capacity}/{cd.capacity}/{ui.capacity}/"
               f"{ud.capacity} out={cc}", main=narrow, host=hus)

        # -- fused extend (one level of a triangle delta plan) -------------
        if narrow:
            pos = [tuple(regs), tuple(regs[:2])]
            neg = [tuple(negs), tuple(negs[:1])]
        else:
            wide = [proj(edges, False, csr.pow2_capacity(edges.shape[0])),
                    proj(fresh, False, cc), proj(ins, False, update_batch)]
            wneg = [proj(gone, False, cc), proj(dels, False, update_batch)]
            pos = [tuple(wide), tuple(wide[:2])]
            neg = [tuple(wneg), tuple(wneg[:1])]
        member_edge_checks(pos[0][0], edges, narrow, label, seed)
        Bp = 8192
        W = Bp
        seeds = np.concatenate([ins, dels])
        nseed = min(seeds.shape[0], W)
        window = np.zeros((W, 2), np.int32)
        window[:nseed] = seeds[:nseed]
        kdt = torch.int32 if narrow else torch.int64
        qks = [torch.from_numpy(window[:, 1].copy()).to(dev, kdt),
               torch.from_numpy(window[:, 0].copy()).to(dev, kdt)]
        wk = torch.zeros(W, dtype=torch.int32, device=dev)
        valid = torch.arange(W, device=dev) < nseed

        def ext_k():
            return eops.fused_extend(pos, neg, qks, wk, valid, Bp)

        def ext_p():
            return eref.fused_extend_ref(pos, neg, qks, wk, valid, Bp)

        got, want = ext_k(), ext_p()
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(ext_k, reps)
        hus = host_us(ext_k, reps)
        dms = device_ms(ext_k, reps, "fused_extend")
        pms = cuda_ms(ext_p, max(reps // 10, 2))
        nreg = sum(len(p) + len(n) for p, n in zip(pos, neg))
        # data-dependent work: two range searches per valid window row in
        # every positive region; each of the P proposals gathers one value
        # and is searched in every negative region and, at the least, in
        # the positives of the binding that is cheaper to search
        P = int(got[5][0])
        nbytes = (W * (2 * qks[0].element_size() + 8) + Bp * 12 + W * 8 + 8
                  + 4 * P
                  + sum(search_bytes(r, 2 * nseed) for p in pos for r in p)
                  + sum(search_bytes(r, P) for n in neg for r in n)
                  + min(sum(search_bytes(r, P) for r in p) for p in pos))
        ops = (2 * nseed * sum(depth(max(int(r.n), 2))
                               for p in pos for r in p)
               + P * sum(depth(max(int(r.n), 2)) for n in neg for r in n)
               + P * min(sum(depth(max(int(r.n), 2)) for r in p)
                         for p in pos))
        record("fused_extend", err, ms, dms, pms, nbytes, ops, None,
               f"{label} W={W} B'={Bp} bindings=2 regions={nreg}",
               main=narrow, host=hus)
    return results


def kernel_phase_lex(tri: np.ndarray, quad: np.ndarray, edges: np.ndarray,
                     update_batch: int, committed: int, reps: int,
                     seed: int) -> dict:
    """The composite (hi, lo) variants at the n-ary path's shapes.

    ``tri``: the triangle relation of the tri serve cell (the live set of a
    ternary relation); ``quad``: a 4-ary relation of 4-clique size, whose
    3-column projection the composite fused extend searches, beside the
    ``edges`` projection of the same plan level."""
    import torch
    from repro_torch.core import csr
    from repro_torch.core.delta import _packed_index
    from repro_torch.kernels.extend import ops as eops, ref as eref
    from repro_torch.kernels.intersect import ops as iops, ref as iref
    from repro_torch.kernels.merge import fold as mfold
    from repro_torch.kernels.merge import ops as mops, ref as mref

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 7)
    results = {}
    record = recorder(results)
    cc = csr.pow2_capacity(committed)

    def rel_rows(rows, n):
        return rows[rng.integers(0, rows.shape[0], n)]

    def fresh_rows(rows, n):
        nv = int(rows.max()) + 1
        return rng.integers(0, nv, (n, rows.shape[1])).astype(np.int32)

    def live(rows, narrow, cap=None):
        """The live-set layout of a relation: key = all its columns."""
        if not narrow:
            return _packed_index(rows, dev, rows.shape[1], capacity=cap)
        ar = rows.shape[1]
        ext = np.concatenate([rows, np.zeros((rows.shape[0], 1), np.int32)],
                             axis=1)
        return csr.build_index(ext, tuple(range(ar)), ar, capacity=max(
            int(cap or 0), csr.pow2_capacity(rows.shape[0])), narrow=True,
            device=dev)

    def pack_q(rows):
        hi, lo = csr.pack_key(tuple(rows[:, c] for c in range(
            rows.shape[1])))
        return (torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev))

    # -- signed membership, merge ranks, commit fold: the live set of the
    # n-ary relation (wide hi, as the store keeps it: the main variant),
    # the same rows with a narrow hi, and the 4-ary relation
    for label, rows, narrow, main in (("tri i64", tri, False, True),
                                      ("tri i32", tri, True, False),
                                      ("quad i64", quad, False, False)):
        base = live(rows, narrow)
        ci = live(fresh_rows(rows, committed), narrow, cc)
        cd = live(rel_rows(rows, committed // 3), narrow, cc)
        ui = live(fresh_rows(rows, update_batch), narrow, update_batch)
        ud = live(rel_rows(rows, update_batch // 4), narrow, update_batch)
        kb = base.key.element_size()
        # normalize: a batch of the tri epoch's size (its probe rung)
        B = csr.pow2_capacity(8 * update_batch)
        qrows = np.concatenate([rel_rows(rows, B // 2),
                                fresh_rows(rows, B - B // 2)])
        qk = pack_q(qrows)
        if narrow:
            qk = (qk[0].to(torch.int32), qk[1])
        qv = torch.zeros(B, dtype=torch.int32, device=dev)
        mregs, mnegs = [base, ci], [cd]

        def mem_k():
            return iops.signed_member(mregs, mnegs, qk, qv)

        got, want = mem_k(), iref.signed_member_ref(mregs, mnegs, qk, qv)
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(mem_k, reps)
        hus = host_us(mem_k, reps)
        dms = device_ms(mem_k, reps, "signed_member_lex")
        pms = cuda_ms(lambda: iref.signed_member_ref(mregs, mnegs, qk, qv),
                      max(reps // 10, 2))
        nbytes = B * (kb + 12) + 2 * 4 * B + sum(
            search_bytes(r, B) for r in mregs + mnegs)
        ops = B * sum(depth(max(int(r.n), 2)) for r in mregs + mnegs)
        record("signed_member_lex", err, ms, dms, pms, nbytes, ops, None,
               f"{label} B={B} regions=2+1 cap={base.capacity} "
               f"n={int(base.n)}", main=main, host=hus)

        # -- single-region membership of the same queries in the base
        if main:
            def lmem_k():
                return iops.member(base.key, base.val, base.n, qk[0], qv,
                                   los=base.lo, ql=qk[1])

            def lmem_p():
                return iref.member_ref(base.key, base.val, base.n, qk[0],
                                       qv, los=base.lo, ql=qk[1])

            got, want = lmem_k(), lmem_p()
            sync()
            err = max_abs_err((got,), (want,))
            ms = cuda_ms(lmem_k, reps)
            hus = host_us(lmem_k, reps)
            dms = device_ms(lmem_k, reps, "member_lex")
            pms = cuda_ms(lmem_p, max(reps // 10, 2))
            nbytes = B * (kb + 12) + B + search_bytes(base, B)
            ops = B * depth(max(int(base.n), 2))
            record("member_lex", err, ms, dms, pms, nbytes, ops, None,
                   f"{label} B={B} region=1 cap={base.capacity} "
                   f"n={int(base.n)}", main=True, host=hus)

        # -- merge ranks: compaction ranks every base entry against cdel
        def rank_k():
            return mops.rank_lt_le(cd.key, cd.val, cd.n, base.key, base.val,
                                   lo=cd.lo, qlo=base.lo)

        got = rank_k()
        want = mref.rank_ref(cd.key, cd.val, cd.n,
                             base.key.to(torch.int64), base.val, lo=cd.lo,
                             qlo=base.lo)
        sync()
        err = max_abs_err(got, want)
        rreps = max(reps // 10, 3)
        ms = cuda_ms(rank_k, rreps)
        hus = host_us(rank_k, rreps)
        dms = device_ms(rank_k, rreps, "rank_lt_le_lex")
        pms = cuda_ms(lambda: mref.rank_ref(
            cd.key, cd.val, cd.n, base.key.to(torch.int64), base.val,
            lo=cd.lo, qlo=base.lo), 2)
        Bq = base.capacity
        nbytes = Bq * (kb + 12) + 2 * 4 * Bq + search_bytes(cd, 2 * Bq)
        ops = 2 * Bq * depth(max(int(cd.n), 2))
        record("rank_lt_le_lex", err, ms, dms, pms, nbytes, ops, None,
               f"{label} B={Bq} cap={cd.capacity} n={int(cd.n)}", main=main,
               host=hus)

        # -- commit fold of the live set
        lt, le = csr.index_ranks(base, csr._qcols_of(ud), ud.val, plain=True)
        in_ba = (le > lt).to(torch.int32)

        def fold_k():
            return mfold.commit_fold(ci, cd, ui, ud, in_ba, cins_cap=cc,
                                     cdel_cap=cc)

        def fold_p():
            return mfold._commit_fold_ref(ci, cd, ui, ud, in_ba, cc, cc)

        got, want = fold_k(), fold_p()
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(fold_k, reps)
        hus = host_us(fold_k, reps)
        dms = device_ms(fold_k, reps, "commit_fold_lex")
        pms = cuda_ms(fold_p, max(reps // 10, 2))
        n4 = [int(r.n) for r in (ci, cd, ui, ud)]
        nbytes = sum(n * entry_bytes(r) + 4 for n, r in
                     zip(n4, (ci, cd, ui, ud))) + 4 * n4[3] \
            + 2 * cc * entry_bytes(ci) + 8
        ops = sum(n4) * 3 * depth(cc)
        record("commit_fold_lex", err, ms, dms, pms, nbytes, ops, None,
               f"{label} caps={ci.capacity}/{cd.capacity}/{ui.capacity}/"
               f"{ud.capacity} out={cc}", main=main, host=hus)

    # -- fused extend: one level of a quad-seeded 5-clique-quad delta plan,
    # a composite binding over the quad relation's 3-column projection
    # beside a 1-word binding over the edge projection ([[3, 1]])
    def qproj(rows, narrow, cap=None):
        return csr.build_index(rows, (0, 1, 2), 3, capacity=cap,
                               narrow=narrow, device=dev)

    def eproj(rows, cap=None):
        return csr.build_index(rows, (0,), 1, capacity=cap, narrow=True,
                               device=dev)

    Bp = W = 8192
    seeds = rel_rows(quad, update_batch + update_batch // 4)
    nseed = min(seeds.shape[0], W)
    window = np.zeros((W, 4), np.int32)
    window[:nseed] = seeds[:nseed]
    wk = torch.zeros(W, dtype=torch.int32, device=dev)
    valid = torch.arange(W, device=dev) < nseed
    e_pos = (eproj(edges, csr.pow2_capacity(edges.shape[0])),
             eproj(fresh_rows(edges, committed), cc))
    e_neg = (eproj(rel_rows(edges, committed // 3), cc),)
    for label, narrow, main in (("i32", True, True), ("i64", False, False)):
        q_pos = (qproj(quad, narrow, csr.pow2_capacity(quad.shape[0])),
                 qproj(fresh_rows(quad, committed), narrow, cc),
                 qproj(fresh_rows(quad, update_batch), narrow, update_batch))
        q_neg = (qproj(rel_rows(quad, committed // 3), narrow, cc),
                 qproj(rel_rows(quad, update_batch // 4), narrow,
                       update_batch))
        pos, neg = [q_pos, e_pos], [q_neg, e_neg]
        member_edge_checks(q_pos[0], quad, narrow, f"composite {label}",
                           seed)
        qh, ql = pack_q(window[:, :3])
        qks = [(qh.to(torch.int32) if narrow else qh, ql),
               torch.from_numpy(window[:, 3].copy()).to(dev)]

        def ext_k():
            return eops.fused_extend(pos, neg, qks, wk, valid, Bp)

        def ext_p():
            return eref.fused_extend_ref(pos, neg, qks, wk, valid, Bp)

        got, want = ext_k(), ext_p()
        sync()
        err = max_abs_err(got, want)
        ms = cuda_ms(ext_k, reps)
        hus = host_us(ext_k, reps)
        dms = device_ms(ext_k, reps, "fused_extend_lex")
        pms = cuda_ms(ext_p, max(reps // 10, 2))
        P = int(got[5][0])
        nreg = sum(len(p) + len(n) for p, n in zip(pos, neg))
        nbytes = (W * (qks[0][0].element_size() + 8 + 4 + 8) + Bp * 12
                  + W * 8 + 8 + 4 * P
                  + sum(search_bytes(r, 2 * nseed) for p in pos for r in p)
                  + sum(search_bytes(r, P) for n in neg for r in n)
                  + min(sum(search_bytes(r, P) for r in p) for p in pos))
        ops = (2 * nseed * sum(depth(max(int(r.n), 2))
                               for p in pos for r in p)
               + P * sum(depth(max(int(r.n), 2)) for n in neg for r in n)
               + P * min(sum(depth(max(int(r.n), 2)) for r in p)
                         for p in pos))
        record("fused_extend_lex", err, ms, dms, pms, nbytes, ops, None,
               f"{label} W={W} B'={Bp} bindings=3-col+1-col "
               f"regions={nreg} quad n={int(q_pos[0].n)} proposals={P}",
               main=main, host=hus)
    return results


# ---------------------------------------------------------------------------
# phases 4/5: the streaming session
# ---------------------------------------------------------------------------

def run_stream(session, stream, live, epochs, label):
    """Drive ``epochs`` edge update epochs, logging each epoch's time and
    delta sizes; returns (live, per-epoch seconds)."""
    secs = []
    for epoch in range(epochs):
        upd, w = stream.batch_at(epoch, live)
        sync()
        t = time.time()
        res = session.update(upd, w)
        sync()
        secs.append(time.time() - t)
        rows = {n: 0 if d.tuples is None else int(d.tuples.shape[0])
                for n, d in res.deltas.items()}
        log(f"  {label} epoch {epoch}: {secs[-1] * 1e3:.1f} ms, "
            f"delta rows {rows}")
        live = res.advance(live)
    return live, secs


def serve_phase(edges, nv, queries, epochs, update_batch, ratio, seed):
    import torch
    from repro_torch import kernels
    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream

    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    session = GraphSession(edges, device=DEVICE, update_batch=update_batch,
                           compact_ratio=ratio)
    handles = {n: session.register(n) for n in queries}
    log(f"  serve: session over |E|={edges.shape[0]} built in "
        f"{time.time() - t:.2f} s")
    stream = EdgeUpdateStream(nv, update_batch, seed=seed + 2)
    kernels.reset_launches()
    live, secs = run_stream(session, stream, edges, epochs,
                            f"serve {edges.shape[0]} edges")
    counts = kernels.launches()
    n_live = session.num_edges
    if n_live != live.shape[0]:
        raise AssertionError(f"serve: live edges {n_live} != host-tracked "
                             f"{live.shape[0]}")
    require_launches("serve", counts, expected_kernels(handles, ()))
    upd, w = stream.batch_at(epochs, live)
    wall, busy, idle, rec, exp = idle_share(lambda: session.update(upd, w))
    log(f"  serve: profiled warm epoch {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {idle} ({rec} of {exp} kernel "
        f"launches recorded)")
    warm = np.asarray(secs[1:]) * 1e3
    out = dict(
        epochs=epochs, edges=int(edges.shape[0]), live_edges=int(n_live),
        first_epoch_ms=secs[0] * 1e3,
        warm_p50_ms=float(np.percentile(warm, 50)),
        warm_p99_ms=float(np.percentile(warm, 99)),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        compactions=session.stats.compactions,
        live_compactions=session.stats.live_compactions,
        escalations=session.stats.escalations, launches=counts,
        profiled_epoch_ms=wall * 1e3, device_busy_ms=busy * 1e3,
        idle_share=idle, profiled_launches_recorded=[rec, exp],
        delta_rows={n: int(h.last_delta.tuples.shape[0]
                           if h.last_delta.tuples is not None else 0)
                    for n, h in handles.items()})
    log("  serve: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# the n-ary path: a relation materialised from one query, fed its deltas
# ---------------------------------------------------------------------------

FEEDS = {"tri": "triangle", "quad": "4-clique"}  # relation <- its feeder
SESSION_KERNELS = ("signed_member", "fused_extend", "rank_lt_le",
                   "commit_fold")
PATTERNS = {"5-clique-quad": "5-clique-quad(a,b,c,d,e) := quad(a,b,c,d), "
                             "quad(a,b,c,e), e(d,e)"}
TWINS = {"4-clique-tri": "4-clique", "5-clique-quad": "5-clique"}


def query_of(name: str):
    from repro_torch.api import parse_pattern, query_by_name
    return parse_pattern(PATTERNS[name]) if name in PATTERNS \
        else query_by_name(name)


def nary_relations(names):
    """The non-edge relations the named queries read, in first-use order."""
    rels = []
    for n in names:
        for atom in query_of(n).atoms:
            if atom.rel != "edge" and atom.rel not in rels:
                rels.append(atom.rel)
    return rels


def expected_kernels(handles, rels):
    """The launch names a session path must show: the four 1-word kernels
    of the streaming engine; with an n-ary relation its composite
    normalize, commit fold and ranks; and the composite fused extend where
    a delta plan binds 3-4 columns."""
    names = list(SESSION_KERNELS)
    if rels:
        names += ["signed_member_lex", "rank_lt_le_lex", "commit_fold_lex"]
    if any(len(b.key_attrs) >= 3 for h in handles.values()
           for plan in h.engine.plans for lv in plan.levels
           for b in lv.bindings):
        names.append("fused_extend_lex")
    return names


def require_launches(label, counts, names):
    idle = [n for n in names if counts.get(n, 0) == 0]
    if idle:
        raise AssertionError(f"{label}: kernels never launched: {idle} "
                             f"({counts})")


def relation_rows(edges, rel, built, handle=None):
    """The rows of n-ary relation ``rel`` over ``edges`` and the seconds
    their enumeration took on the card: its feeding query enumerated at
    the session's own sizing, through ``handle`` or else a session of its
    own.  A ``built`` dict shared between callers keeps them per graph, so
    the kernels phase and the serve cell over one graph enumerate once."""
    from repro_torch.api import GraphSession
    from repro_torch.core.delta import _unique_rows
    if built is not None and rel in built and built[rel][0] is edges:
        return built[rel][1:]
    if handle is None:
        handle = GraphSession(edges, device=DEVICE).register(FEEDS[rel])
    sync()
    t = time.time()
    rows, _ = handle.enumerate()
    sync()
    out = (_unique_rows(rows), time.time() - t)
    if built is not None:
        built[rel] = (edges,) + out
    return out


def open_nary_session(edges, names, update_batch, ratio, built=None):
    """A session with the edge queries, each n-ary relation materialised
    on the card from its feeding query (``relation_rows``), then the n-ary
    queries.  Returns (session, handles, relations, initial rows, build
    seconds)."""
    from repro_torch.api import GraphSession
    session = GraphSession(edges, device=DEVICE, update_batch=update_batch,
                           compact_ratio=ratio)
    rels = nary_relations(names)
    handles = {}
    for n in names:
        if not nary_relations([n]):
            handles[n] = session.register(n)
    rows0, build = {}, {}
    for rel in rels:
        feeder = FEEDS[rel]
        if feeder not in handles:
            handles[feeder] = session.register(feeder)
        rows0[rel], build[rel] = relation_rows(edges, rel, built,
                                               handles[feeder])
        session.add_relation(rel, rows0[rel])
        log(f"  {rel}: {rows0[rel].shape[0]} tuples from {feeder} in "
            f"{build[rel]:.2f} s on the card")
    for n in names:
        if nary_relations([n]):
            handles[n] = session.register(query_of(n), name=n)
    return session, handles, rels, rows0, build


def feed_of(delta, arity):
    if delta.tuples is None:
        return np.zeros((0, arity), np.int32), np.zeros(0, np.int32)
    return delta.tuples, delta.weights


def nary_epoch(session, rels, upd, w):
    """One logical epoch: the edge batch, then each relation fed its
    feeder's delta.  Returns (edge result, relation result or None without
    relations, seconds of each)."""
    sync()
    t = time.time()
    r1 = session.update(upd, w)
    sync()
    t1 = time.time()
    if not rels:
        return r1, None, t1 - t, 0.0
    feeds = {rel: feed_of(r1.deltas[FEEDS[rel]], session.store.arity_of(rel))
             for rel in rels}
    r2 = session.update(feeds)
    sync()
    return r1, r2, t1 - t, time.time() - t1


def apply_signed(rows, tuples, weights):
    """A host relation advanced by one signed delta, netted per row first
    (a row may come and go within one delta)."""
    from repro_torch.core.delta import _unique_rows, canon_arrays, rows_isin
    if tuples is None or tuples.size == 0:
        return rows
    tuples, net = canon_arrays(tuples, weights, rows.shape[1])
    add = tuples[net > 0]
    rem = tuples[net < 0]
    kept = rows[~rows_isin(rows, rem)] if rem.size else rows
    return _unique_rows(np.concatenate([kept, add])) if add.size else kept


def joined(m, *deltas):
    """Canonical signed union of several deltas of one query."""
    from repro_torch.core.delta import canon_arrays
    t = [d.tuples for d in deltas if d.tuples is not None]
    w = [d.weights for d in deltas if d.weights is not None]
    if not t:
        return canon_arrays(None, None, m)
    return canon_arrays(np.concatenate(t), np.concatenate(w), m)


def verify_phase(scale: int, names, epochs: int, update_batch: int,
                 seed: int):
    """Every epoch: each query's delta (edge epoch + relation epoch) equal
    to the full-recomputation oracle, each n-ary query's equal to its
    edge-only twin's, and each relation's rows equal to the host-tracked
    set; the live edges equal the host-tracked set, compaction runs, and
    every n-ary relation compacts at least twice."""
    from repro_torch import kernels
    from repro_torch.core.delta import _unique_rows, canon_arrays, rows_isin
    from repro_torch.core.generic_join import generic_join
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph

    edges = rmat_graph(scale, 16, seed=seed)
    ratio = 0.5 * update_batch / edges.shape[0]
    session, handles, rels, host, _ = open_nary_session(
        edges, names, update_batch, ratio)

    def relations(q, live):
        return {a.rel: live if a.rel == "edge" else host[a.rel]
                for a in q.atoms}

    def full(q, live):
        return _unique_rows(generic_join(q, relations(q, live))[0])

    prev = {n: full(h.query, edges) for n, h in handles.items()}
    compactions = {rel: 0 for rel in rels}
    kernels.reset_launches()
    stream = EdgeUpdateStream(1 << scale, update_batch, seed=seed + 1)
    live = edges
    for epoch in range(epochs):
        upd, w = stream.batch_at(epoch, live)
        r1, r2, _, _ = nary_epoch(session, rels, upd, w)
        new = r1.advance(live)
        for rel in rels:
            d = r1.deltas[FEEDS[rel]]
            host[rel] = apply_signed(host[rel], d.tuples, d.weights)
            st = session.store._rels[rel]
            if r2.by_rel[rel][0].size + r2.by_rel[rel][1].size and \
                    st.n_live[1] == st.n_live[2] == 0:
                compactions[rel] += 1
        got = {}
        for n, h in handles.items():
            cur = full(h.query, new)
            added = cur[~rows_isin(cur, prev[n])]
            removed = prev[n][~rows_isin(prev[n], cur)]
            m = h.query.num_attrs
            want = canon_arrays(
                np.concatenate([added, removed]),
                np.concatenate([np.ones(added.shape[0], np.int32),
                                -np.ones(removed.shape[0], np.int32)]), m)
            got[n] = joined(m, r1.deltas[n],
                            *(() if r2 is None else (r2.deltas[n],)))
            if not (np.array_equal(got[n][0], want[0])
                    and np.array_equal(got[n][1], want[1])):
                raise AssertionError(f"verify: epoch {epoch} {n} delta "
                                     f"differs from the oracle")
            prev[n] = cur
            log(f"  verify epoch {epoch} {n}: {want[0].shape[0]} delta rows "
                f"== oracle")
        for n, twin in TWINS.items():
            if n in got and twin in got:
                if not (np.array_equal(got[n][0], got[twin][0])
                        and np.array_equal(got[n][1], got[twin][1])):
                    raise AssertionError(f"verify: epoch {epoch} {n} != "
                                         f"{twin}")
                log(f"  verify epoch {epoch} {n} == {twin}")
        for rel in rels:
            if not np.array_equal(session.relation(rel), host[rel]):
                raise AssertionError(f"verify: epoch {epoch} relation "
                                     f"{rel} differs from the host set")
        live = new
    counts = kernels.launches()
    if not np.array_equal(session.edges, live):
        raise AssertionError("verify: live edge set differs")
    if session.stats.compactions == 0:
        raise AssertionError("verify: no compaction ran")
    log(f"  verify: |E|={edges.shape[0]} epochs={epochs} "
        f"compactions={session.stats.compactions} relations="
        f"{ {rel: host[rel].shape[0] for rel in rels} } relation "
        f"compactions={compactions} launches={counts}")
    thin = [rel for rel, c in compactions.items() if c < 2]
    if thin:
        raise AssertionError(f"verify: {thin} compacted fewer than twice")
    require_launches("verify", counts, expected_kernels(handles, rels))
    return counts


def serve_nary_phase(edges, nv, names, epochs, update_batch, ratio, seed,
                     built):
    """The n-ary path at a realistic state size: warm latency of the edge
    epoch and of the relation epoch apart, the relation's build time on
    the card (taken where it was enumerated, the kernels phase for the
    default cell), peak device memory from the session's opening on,
    launches, and one profiled epoch."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import EdgeUpdateStream

    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    session, handles, rels, host, build = open_nary_session(
        edges, names, update_batch, ratio, built)
    log(f"  serve: n-ary session over |E|={edges.shape[0]} built in "
        f"{time.time() - t:.2f} s")
    stream = EdgeUpdateStream(nv, update_batch, seed=seed + 2)
    kernels.reset_launches()
    live = edges
    e_secs, r_secs = [], []
    for epoch in range(epochs):
        upd, w = stream.batch_at(epoch, live)
        r1, r2, te, tr = nary_epoch(session, rels, upd, w)
        e_secs.append(te)
        r_secs.append(tr)
        live = r1.advance(live)
        sizes = {}
        for rel in rels:
            d = r1.deltas[FEEDS[rel]]
            host[rel] = apply_signed(host[rel], d.tuples, d.weights)
            sizes[rel] = session.num_tuples(rel)
            if sizes[rel] != host[rel].shape[0]:
                raise AssertionError(
                    f"serve: {rel} holds {sizes[rel]} tuples, the host set "
                    f"{host[rel].shape[0]}")
        rows = {n: sum(0 if d.tuples is None else int(d.tuples.shape[0])
                       for d in (r1.deltas[n], r2.deltas[n]))
                for n in handles}
        log(f"  serve n-ary epoch {epoch}: edge {te * 1e3:.1f} ms, "
            f"{'+'.join(rels)} {tr * 1e3:.1f} ms, sizes {sizes} == host, "
            f"delta rows {rows}")
    counts = kernels.launches()
    if session.num_edges != live.shape[0]:
        raise AssertionError("serve: live edge count differs")
    expected = expected_kernels(handles, rels)
    require_launches("serve", counts, expected)
    upd, w = stream.batch_at(epochs, live)
    held = {}
    e_prof = idle_share(lambda: held.update(r1=session.update(upd, w)))
    d = held["r1"].deltas
    feeds = {rel: feed_of(d[FEEDS[rel]], session.store.arity_of(rel))
             for rel in rels}
    r_prof = idle_share(lambda: session.update(feeds))
    for tag, (wall, busy, idle, rec, exp) in (("edge", e_prof),
                                              ("relation", r_prof)):
        log(f"  serve: profiled warm {tag} epoch {wall * 1e3:.1f} ms, "
            f"device busy {busy * 1e3:.1f} ms, idle share {idle} ({rec} of "
            f"{exp} kernel launches recorded)")
    ew, rw = np.asarray(e_secs[1:]) * 1e3, np.asarray(r_secs[1:]) * 1e3
    out = dict(
        epochs=epochs, edges=int(edges.shape[0]),
        relations={rel: int(session.num_tuples(rel)) for rel in rels},
        relation_build_s=build,
        first_edge_epoch_ms=e_secs[0] * 1e3,
        first_relation_epoch_ms=r_secs[0] * 1e3,
        edge_warm_p50_ms=float(np.percentile(ew, 50)),
        edge_warm_p99_ms=float(np.percentile(ew, 99)),
        relation_warm_p50_ms=float(np.percentile(rw, 50)),
        relation_warm_p99_ms=float(np.percentile(rw, 99)),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        compactions=session.stats.compactions,
        live_compactions=session.stats.live_compactions,
        escalations=session.stats.escalations, launches=counts,
        expected_kernels=expected,
        idle_share={"edge": e_prof[2], "relation": r_prof[2]},
        profiled_ms={"edge": e_prof[0] * 1e3, "relation": r_prof[0] * 1e3},
        device_busy_ms={"edge": e_prof[1] * 1e3,
                        "relation": r_prof[1] * 1e3},
        profiled_launches_recorded={"edge": e_prof[3:], "relation":
                                    r_prof[3:]})
    log("  serve: " + json.dumps(out))
    if max(r_secs[1:]) > 15.0:
        log("  serve: a relation epoch exceeded 15 s")
    return out


# ---------------------------------------------------------------------------
# phases 6-8: GNN training (motif features -> sampler -> GNN with
# segment_sum -> loss -> autograd -> AdamW -> checkpoint)
# ---------------------------------------------------------------------------

# the minibatch_lg shape: the 232,965-node graph of its note at the
# driver's 8 edges per node, 1024 seeds at fanouts 15-10 per step
TRAIN_NODES = 232_965
TRAIN_SEEDS = 1024
TRAIN_FANOUTS = [15, 10]
TRAIN_STEPS = 6  # 1 cold + 5 warm
SMOKE_ARCHS = ("egnn", "gat-cora", "graphcast", "gatedgcn")
# segment_sum against its plain version: f32 sums in another order
# (tile partials, then partials in row order, against index_add_'s row
# order); f16 at the JAX package's own f16 tolerance (tests/test_kernels.py)
SEGSUM_TOL = {"f32": (1e-5, 1e-4), "f16": (2e-2, 1e-3)}
# card against host for one training step: f32 on both, matmuls and sums
# in another order, through 16 layers at full width / 2 at smoke width
FULL_STEP_RTOL = 1e-3
SMOKE_STEP_RTOL = 1e-4


def segment_sum_rows(table: dict, dst: np.ndarray, mask: np.ndarray,
                     NS: int, D: int, reps: int, seed: int) -> None:
    """segment_sum against its plain version on the card at the trainer's
    shape: the rows sorted by destination as the wrapper sorts them, with
    the trainer's layout of values (random messages on real edges, zeros
    on the masked padding edges, which all point at node 0): f32 (the main
    row), f16, and f32 through the unsorted wrapper path.  Then random
    values on every row, the padding hub included, and random values with
    every row in segment 0, against the plain version in float64: the
    kernel's error no larger than the f32 plain version's (whose atomic
    adds run in a run-dependent order).  Every row also holds two calls of
    the kernel bitwise equal: its order of sums depends on the ids
    alone."""
    import torch
    from repro_torch.kernels.segment_ops import ops as sops, ref as sref
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 13)
    order = np.argsort(dst, kind="stable")
    E = dst.shape[0]
    seg = torch.from_numpy(dst[order].astype(np.int32)).to(dev)
    live = torch.from_numpy(mask[order]).to(dev)
    per_call = {"segsum_level": sops.kernel_launches(E) - 1}
    record = recorder(table)
    for label, dtype, is_sorted, kind in (
            ("f32", torch.float32, True, "trainer"),
            ("f16", torch.float16, True, "trainer"),
            ("f32", torch.float32, False, "trainer"),
            ("f32", torch.float32, True, "hub"),
            ("f32", torch.float32, True, "one segment")):
        data = torch.from_numpy(rng.normal(size=(E, D)).astype(
            np.float32)).to(dev)
        if kind == "trainer":
            data = data * live[:, None]
        data = data.to(dtype)
        ids = seg if kind != "one segment" else torch.zeros_like(seg)
        if not is_sorted:
            perm = torch.from_numpy(rng.permutation(E)).to(dev)
            data, ids = data[perm], ids[perm]

        def k():
            return sops.segment_sum(data, ids, NS, is_sorted=is_sorted)

        def p():
            return sref.segment_sum_ref(data, ids, NS)

        got = k()
        again = k()
        want = p() if kind == "trainer" else torch.zeros(
            NS, D, dtype=torch.float64, device=dev).index_add_(
                0, ids.long(), data.double())  # every id is below NS
        sync()
        rtol, atol = SEGSUM_TOL[label]
        err = float((got.double() - want.double()).abs().max())
        what = (f"segment_sum {label} sorted={is_sorted}"
                f"{'' if kind == 'trainer' else f' {kind}, all rows random'}")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls differ")
        if kind != "trainer":
            # a sum of ~10^5 rows: the rounding scales with its partial
            # sums, not with the result, so the kernel is held to be no
            # less exact than the f32 plain version
            plain_err = float((p().double() - want).abs().max())
            log(f"  {what}: max |err| against float64: kernel {err}, f32 "
                f"plain version {plain_err} (segment 0 holds "
                f"{int((ids == 0).sum())} rows); two calls bitwise equal")
            if got.shape != want.shape or err > max(plain_err, atol):
                raise AssertionError(f"{what}: the kernel's error {err} "
                                     f"exceeds the plain version's "
                                     f"{plain_err}")
            if kind == "hub":
                continue
        elif got.dtype != torch.float32 or got.shape != want.shape or \
                not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{what} disagrees with its plain version "
                                 f"(max |err| = {err})")
        ms = cuda_ms(k, reps)
        hus = host_us(k, reps)
        dms = device_ms(k, reps, "segment_sum", per_call=per_call)
        pms = cuda_ms(p, max(reps // 10, 2))
        acc = torch.zeros(NS, D, dtype=dtype, device=dev)
        idx = ids.long()

        def lib():
            return acc.index_add_(0, idx, data)
        lms = cuda_ms(lib, reps)
        ldms = library_device_ms(lib, reps, "index_add_")
        nbytes = E * D * data.element_size() + E * 4 + NS * D * 4
        record("segment_sum", err, ms, dms, pms, nbytes, E * D, lms,
               f"{label} E={E} D={D} NS={NS} "
               f"{'sorted' if is_sorted else 'unsorted'}"
               f"{'' if kind == 'trainer' else ', ' + kind} rtol={rtol} "
               f"atol={atol}; {sum(per_call.values()) + 1} launches a call",
               main=label == "f32" and is_sorted and kind == "trainer",
               library_device_ms=ldms, host=hus,
               library=f"index_add_ ({dtype})")


def train_driver_phase(seed: int) -> dict:
    """The port's driver (``launch/train.py`` main) with --arch gatedgcn
    at its defaults, to step 10 and relaunched to step 20 in one
    checkpoint directory: it must resume from step 10 and end with a
    finite loss.  Returns the kernel launches of both runs."""
    import contextlib
    import io
    import tempfile
    from repro_torch import kernels
    from repro_torch.launch import train
    runs = []
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as ck:
        for steps in (10, 20):
            buf = io.StringIO()
            t = time.time()
            with contextlib.redirect_stdout(buf):
                loss = train.main(["--arch", "gatedgcn", "--steps",
                                   str(steps), "--seed", str(seed),
                                   "--ckpt-dir", ck])
            runs.append((loss, buf.getvalue()))
            log(f"  train driver --steps {steps}: {time.time() - t:.2f} s")
            for line in buf.getvalue().splitlines():
                log(f"    {line}")
    counts = kernels.launches()
    if "resumed from step 10" not in runs[1][1]:
        raise AssertionError("train driver: the relaunch did not resume "
                             "from step 10")
    if not np.isfinite(runs[1][0]):
        raise AssertionError(f"train driver: final loss {runs[1][0]}")
    require_launches("train driver", counts, ["segment_sum",
                                              "fused_extend"])
    log(f"  train driver: launches {counts}")
    return counts


def _loss_and_gnorm(model, batch, cfg):
    """One forward and backward: (loss, pre-clip global gradient norm)."""
    from repro_torch.models import gnn as G
    from repro_torch.optim import clip_by_global_norm
    model.zero_grad(set_to_none=True)
    loss, _ = G.loss_fn(model, batch, cfg)
    loss.backward()
    _, norm = clip_by_global_norm(
        {k: p.grad for k, p in model.named_parameters()}, 1.0)
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), float(norm)


def _close(a: float, b: float, rtol: float) -> bool:
    return bool(np.isfinite(a) and abs(a - b) <= rtol * abs(b))


def train_full_phase(table: dict, reps: int, seed: int) -> dict:
    """GatedGCN at full width (16 layers, d 70; the minibatch_lg shape:
    d_in 602, 41 classes) on a 232,965-node uniform graph: motif features
    on the card, the sampler's union graphs padded to the shape, the
    segment_sum kernel rows at this shape, the first step's loss and
    gradient norm against the host's, then TRAIN_STEPS training steps."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import (SHAPES, _shape_cfg,
                                                make_train_step)
    from repro_torch.core.csr import Graph
    from repro_torch.data.graph_sampler import NeighborSampler
    from repro_torch.data.motifs import motif_features
    from repro_torch.data.synthetic import uniform_graph
    from repro_torch.kernels.segment_ops import ops as sops
    from repro_torch.launch.train import union_batch
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init

    shape = SHAPES["minibatch_lg"]
    cfg = _shape_cfg(get_arch("gatedgcn").full_config, shape)
    n_max = -(-shape["n_nodes"] // 512) * 512  # as the JAX dry-run pads
    e_max = -(-shape["n_edges"] // 512) * 512
    nv = TRAIN_NODES
    edges = uniform_graph(nv, 8 * nv, seed=seed)
    graph = Graph.from_edges(edges, nv)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    kernels.reset_launches()
    sync()
    t = time.time()
    motifs = motif_features(graph, ("triangle",))  # on the card
    sync()
    motif_s = time.time() - t
    add(kernels.launches())
    triangles = int(round(float(np.expm1(motifs[:, 0].astype(
        np.float64)).sum()) / 3))
    log(f"  train full: |V|={nv} |E|={graph.num_edges}, {triangles} "
        f"triangles enumerated on the card in {motif_s:.2f} s "
        f"(launches {kernels.launches()})")
    rng = np.random.default_rng(seed)
    feats = np.concatenate([rng.normal(size=(nv, shape["d_feat"] - 1))
                            .astype(np.float32), motifs], 1)
    labels = (motifs[:, 0] > np.median(motifs[:, 0])).astype(np.int32)
    sampler = NeighborSampler(edges, nv)
    batches, sizes = [], []
    t = time.time()
    for s in range(TRAIN_STEPS):
        srng = np.random.default_rng(seed * 7919 + s)
        seeds = srng.choice(nv, TRAIN_SEEDS, replace=False)
        blocks = sampler.sample_blocks(seeds, TRAIN_FANOUTS, seed=seed + s)
        sizes.append((len(blocks[0].src_nodes),
                      sum(len(b.edge_src) for b in blocks)))
        batches.append(union_batch(blocks, seeds, feats, labels, n_max,
                                   e_max, DEVICE))
    sample_s = time.time() - t
    log(f"  train full: {TRAIN_STEPS} union graphs (nodes, edges) {sizes} "
        f"padded to ({n_max}, {e_max}) in {sample_s:.2f} s")
    del feats

    # the kernel at the trainer's shape: the destinations of the first
    # union graph (its padding edges all point at node 0)
    segment_sum_rows(table, batches[0]["edge_dst"].cpu().numpy(),
                     batches[0]["edge_mask"].cpu().numpy(), n_max,
                     cfg.d_hidden, reps, seed)

    # the first step on the card against the same step on the host
    model = G.GNN(cfg, seed=seed)
    host = G.GNN(cfg, seed=seed, device="cpu")
    kernels.reset_launches()
    card = _loss_and_gnorm(model, batches[0], cfg)
    add(kernels.launches())
    t = time.time()
    cpu = _loss_and_gnorm(host, {k: v.cpu() for k, v in
                                 batches[0].items()}, cfg)
    log(f"  train full: first step loss / grad norm card {card}, host "
        f"{cpu} (host step {time.time() - t:.2f} s)")
    if not (_close(card[0], cpu[0], FULL_STEP_RTOL)
            and _close(card[1], cpu[1], FULL_STEP_RTOL)):
        raise AssertionError(f"train full: the card's first step {card} "
                             f"differs from the host's {cpu}")
    del host

    opt = adamw_init(model)
    step_fn = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    secs, per_step, losses = [], [], []
    for b in batches:
        kernels.reset_launches()
        sync()
        t = time.time()
        m = step_fn(model, opt, b)
        loss = float(m["loss"])
        sync()
        secs.append(time.time() - t)
        counts = kernels.launches()
        add(counts)
        per_step.append(counts["segment_sum"])
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train full: step ms {[round(x * 1e3, 3) for x in secs]}, "
        f"losses {losses}, segment_sum launches per step {per_step}")
    if any(n != 2 * cfg.n_layers for n in per_step):
        raise AssertionError(f"train full: segment_sum launches per step "
                             f"{per_step}, expected {2 * cfg.n_layers}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"train full: losses {losses}")
    by_name = {}
    wall, busy, idle, rec, exp = idle_share(
        lambda: step_fn(model, opt, batches[-1]), by_name,
        per_call={"segment_sum": sops.kernel_launches(e_max)})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"  train full: profiled warm step {wall * 1e3:.1f} ms, device "
        f"busy {busy * 1e3:.1f} ms, idle share {idle} ({rec} of {exp} "
        f"kernel launches recorded); device time by kernel (launches, ms):")
    for name, (n, ms) in top:
        log(f"    {ms:10.3f} ms {n:5d}x {name}")
    warm = np.asarray(secs[1:]) * 1e3
    out = dict(
        layers=cfg.n_layers, d_hidden=cfg.d_hidden, d_in=cfg.d_in,
        d_out=cfg.d_out, nodes=nv, edges=graph.num_edges,
        union_sizes=sizes, padded=[n_max, e_max], motif_s=motif_s,
        triangles=triangles, sample_s=sample_s, first_step_card=card,
        first_step_host=cpu, first_step_ms=secs[0] * 1e3,
        warm_p50_ms=float(np.percentile(warm, 50)),
        warm_p99_ms=float(np.percentile(warm, 99)),
        peak_mem_gib=peak, segment_sum_per_step=per_step,
        profiled_step_ms=wall * 1e3, device_busy_ms=busy * 1e3,
        idle_share=idle, profiled_launches_recorded=[rec, exp],
        top_kernels_ms={n: ms for n, (_c, ms) in top}, launches=totals)
    log("  train full: " + json.dumps(out))
    return totals


def train_archs_phase(seed: int) -> dict:
    """One training step of each arch at its smoke config, and one
    graph_reg batch (graph_id pooling), on the card and on the host from
    the same initial parameters: the losses agree and every card step
    launches segment_sum."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import make_train_step, smoke_batch
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init
    cases = [(a, get_arch(a).smoke_config) for a in SMOKE_ARCHS]
    cases.append(("graph_reg", dataclasses.replace(
        get_arch("gatedgcn").smoke_config, task="graph_reg", d_out=1)))
    totals = {}
    for name, base in cases:
        loss, seg = {}, {}
        for dev in (DEVICE, "cpu"):
            cfg, batch = smoke_batch(base, dev)
            model = G.GNN(cfg, seed=seed, device=dev)
            kernels.reset_launches()
            m = make_train_step(cfg)(model, adamw_init(model), batch)
            loss[dev] = float(m["loss"])
            counts = kernels.launches()
            seg[dev] = counts["segment_sum"]
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        log(f"  train {name}: loss card {loss[DEVICE]} host {loss['cpu']}, "
            f"segment_sum launches {seg[DEVICE]}")
        if seg[DEVICE] == 0 or seg["cpu"] != 0:
            raise AssertionError(f"train {name}: segment_sum launches "
                                 f"{seg}")
        if not _close(loss[DEVICE], loss["cpu"], SMOKE_STEP_RTOL):
            raise AssertionError(f"train {name}: card loss {loss[DEVICE]} "
                                 f"!= host {loss['cpu']}")
    return totals


# ---------------------------------------------------------------------------
# phases 9-10 and the flash rows of phase 3: the LM serving path (gemma2-2b;
# prefill and KV-cache decode through the flash-attention kernel)
# ---------------------------------------------------------------------------

# the six shapes of tests/test_kernels.py's flash-attention sweep
FLASH_CASES = [
    dict(H=2, Sq=256, Sk=256, Dh=64, causal=True, window=0, softcap=0.0),
    dict(H=1, Sq=200, Sk=200, Dh=32, causal=True, window=64, softcap=0.0),
    dict(H=2, Sq=130, Sk=130, Dh=64, causal=True, window=0, softcap=30.0),
    dict(H=1, Sq=1, Sk=300, Dh=64, causal=True, window=0, softcap=0.0,
         q_offset=299),
    dict(H=1, Sq=100, Sk=100, Dh=128, causal=False, window=0, softcap=0.0),
    dict(H=1, Sq=64, Sk=64, Dh=256, causal=True, window=0, softcap=0.0),
]
# kernel against plain: f32 sums in another order (tiles of 32 keys with
# an online softmax against one softmax); bf16 at the JAX package's own
# tolerance (tests/test_kernels.py), the output rounded once to bf16
FLASH_TOL = {"f32": 3e-4, "bf16": 2e-2}
# the serving shapes in bf16 are held at ref.FLASH_SERVE_TOL (rtol 8e-3,
# atol 1e-5: one bf16 step of the output; see ref.py).  Planted faults
# that check must see: the plain version with its causal edge (and
# window) moved back by one key, and by one key tile of the prefill
# kernel (PF_BN = 64): a tile dropped or an edge off by a few keys; at
# decode also the split's combine with one chunk dropped
FLASH_FAULTS = {"one key": 1, "one key tile": 64}
# bf16 card cases of rows without a live key (tests/test_torch_flash_
# attention.py's shape, 3 rows, through the decode route; and 64 rows past
# the window's reach from row 51 on, through the prefill route), and the
# decode kernel run on a plan whose chunks lie wholly masked and past Sk:
# (Sq, Sk, window, q_offset, plan or None), at D 64 and 256
FLASH_EDGE_CASES = [(3, 20, 4, 30, None), (64, 96, 16, 60, None),
                    (1, 500, 100, 499, (0, 700, 100, 7))]
# the serving shape: 4 requests of gemma2-2b's own 8,192-token context,
# then 32 greedy decode steps into an 8,224-row cache
SERVE_BATCH = 4
SERVE_PROMPT = 8192
SERVE_DECODE = 32
SERVE_ROUNDS = 3  # 1 cold + 2 warm
DECODE_OFFSET = 8200  # the kernel rows' decode position in that cache
LM_SMOKE_ARCHS = ("yi-34b", "gemma-7b", "gemma2-2b")
# card against host, f32 on both: matmuls and softmax sums in another
# order (cuBLAS against the host's BLAS, the kernel's online softmax
# against one softmax), |err| <= tol * max(1, max |host|): 2 layers at
# smoke width, 2 layers at full width (d 2304, ff 9216, 4,160 keys)
LM_SMOKE_TOL = 1e-4
LM_FULL_TOL = 1e-3
# decode against prefill at full depth in bf16 on the card, |err| <= tol *
# max |prefill logits|: both round every activation to bf16 (2^-8
# relative), through 26 layers whose matmuls have other shapes (4 rows
# against 4 x 8,193) and so other sum orders and roundings
LM_DECODE_TOL = 0.05


def _lm_arch(arch_id: str):
    from repro_torch.configs.lm_archs import LM_ARCHS
    return {a.arch_id: a for a in LM_ARCHS}[arch_id]


def _pairs(sq: int, sk: int, window: int, q_offset: int) -> int:
    """Live (query, key) pairs of causal attention of ``sq`` rows at
    positions q_offset.. over ``sk`` keys, with a window (0: none)."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(p, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flex_attention(softcap: float, window: int, q_offset: int, sq: int,
                    sk: int):
    """The one PyTorch call that computes the kernel's function with a
    softcap: ``flex_attention``, compiled, with the tanh cap as its score
    modification and the causal window at ``q_offset`` as its block mask.
    Returns ``f(q, k, v)`` on the transformer's [B, S, H, D] layout; the
    port never calls it.  Inductor's and Triton's caches go to the build
    directory."""
    import torch
    from torch._inductor import config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels._build import build_dir
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build_dir() / sub))
    inductor_config.compile_threads = 1  # no pool of compile workers

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def live(b, h, q_idx, kv_idx):
        pos = q_idx + q_offset
        ok = kv_idx <= pos
        if window > 0:
            ok = ok & (kv_idx > pos - window)
        return ok

    mask = create_block_mask(live, B=None, H=None, Q_LEN=sq, KV_LEN=sk,
                             device=DEVICE)
    fn = torch.compile(flex_attention, dynamic=False)

    def run(q, k, v):
        return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  score_mod=cap if softcap > 0 else None, block_mask=mask,
                  enable_gqa=True).transpose(1, 2)
    return run


def flash_rows(table: dict, reps: int, seed: int) -> None:
    """The flash-attention kernels against their plain version on the card:
    the six shapes of the JAX package's sweep in f32 and bf16; rows
    without a live key and a decode plan with masked chunks and chunks
    past Sk in bf16; then gemma2-2b's serving shapes in bf16 (prefill of 4
    x 8,192 tokens, a local layer with window 4096 and a global one;
    decode of one token per request at position 8,200 of an 8,224-row
    cache, both layers), each held at FLASH_SERVE_TOL, with planted faults
    that check must catch, and with its time, device time, plain time and
    bound; the library time of each softcapped shape is compiled
    ``flex_attention``.  And the prefill without softcap, the attention of
    yi-34b and gemma-7b, beside scaled_dot_product_attention.  The port
    calls neither library function.  A bf16 prefill must run the
    tensor-core kernel and never the f32 one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 17)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def excess(got, want, rtol, atol):
        """(max |got - want|, largest |got - want| / (atol + rtol |want|):
        the check passes at most 1)."""
        d = (got.float() - want.float()).abs()
        lim = atol + rtol * want.float().abs()
        return float(d.max()), float((d / lim).max())

    def check(what, got, want, rtol, atol):
        err, ratio = excess(got, want, rtol, atol)
        if got.dtype != want.dtype or got.shape != want.shape or \
                not ratio <= 1.0:
            raise AssertionError(f"flash_attention {what} disagrees with "
                                 f"its plain version (max |err| = {err}, "
                                 f"{ratio} of the limit)")
        return err, ratio

    worst = 0.0
    for case in FLASH_CASES:
        c = dict(case)
        qo = c.pop("q_offset", 0)
        for label, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            q = randn((c["H"], c["Sq"], c["Dh"]), dtype)
            k = randn((c["H"], c["Sk"], c["Dh"]), dtype)
            v = randn((c["H"], c["Sk"], c["Dh"]), dtype)
            kw = dict(causal=c["causal"], window=c["window"],
                      softcap=c["softcap"], scale=c["Dh"] ** -0.5,
                      q_offset=qo)
            got = fops.flash_attention(q, k, v, **kw)
            want = fref.attention_ref(q, k, v, **kw)
            sync()
            tol = FLASH_TOL[label]
            err, _ = check(f"{label} {case}", got, want, tol, tol)
            worst = max(worst, err)
            log(f"  flash_attention {label} H={c['H']} Sq={c['Sq']} "
                f"Sk={c['Sk']} Dh={c['Dh']} causal={c['causal']} "
                f"window={c['window']} softcap={c['softcap']} "
                f"q_offset={qo}: max |err| {err} (tol {tol})")

    rtol, atol = fref.FLASH_SERVE_TOL["rtol"], fref.FLASH_SERVE_TOL["atol"]
    bf16 = torch.bfloat16
    for sq, sk, window, qo, plan in FLASH_EDGE_CASES:
        for d in (64, 256):
            q = randn((1, sq, 1, d), bf16)
            k = randn((1, sk, 1, d), bf16)
            v = randn((1, sk, 1, d), bf16)
            kw = dict(causal=True, window=window, softcap=0.0, q_offset=qo)
            got = fops._launch(q, k, v, True, window, 0.0, d ** -0.5, qo,
                               plan=plan)
            want = fref.mha_ref(q, k, v, **kw)
            sync()
            what = (f"bf16 Sq={sq} Sk={sk} D={d} window={window} "
                    f"q_offset={qo} plan={plan}")
            err, ratio = check(what, got, want, rtol, atol)
            worst = max(worst, err)
            log(f"  flash_attention {what} ({fops.route(bf16, sq, d)}): "
                f"max |err| {err}, {ratio:.4f} of the limit")

    cfg = _lm_arch("gemma2-2b").full_config
    B, S, H, K, D = (SERVE_BATCH, SERVE_PROMPT, cfg.n_heads,
                     cfg.n_kv_heads, cfg.head_dim)
    smax = SERVE_PROMPT + SERVE_DECODE
    record = recorder(table)
    table.setdefault("flash_attention", dict(max_abs_err=0))
    table["flash_attention"]["max_abs_err"] = worst
    q = randn((B, S, H, D), bf16)
    k = randn((B, S, K, D), bf16)
    v = randn((B, S, K, D), bf16)
    qd = randn((B, 1, H, D), bf16)
    kc = randn((B, smax, K, D), bf16)
    vc = randn((B, smax, K, D), bf16)
    softcap = cfg.attn_softcap
    # first every kernel row (check, faults, times, profiled kernels), then
    # the library calls: once Triton has launched a kernel in the process,
    # the profiler loses whole sessions of records (device_ms retries)
    rows = []
    for label, args, window, cap, q_offset, main in (
            ("prefill global", (q, k, v), 0, softcap, 0, True),
            ("prefill local", (q, k, v), cfg.window, softcap, 0, False),
            ("prefill global, no softcap", (q, k, v), 0, 0.0, 0, False),
            ("decode global", (qd, kc, vc), 0, softcap, DECODE_OFFSET,
             False),
            ("decode local", (qd, kc, vc), cfg.window, softcap,
             DECODE_OFFSET, False)):
        kw = dict(causal=True, window=window, softcap=cap,
                  q_offset=q_offset)
        qq, kk, vv = args
        decode = q_offset > 0
        names = (("flash_decode_split", "flash_decode_combine") if decode
                 else ("flash_prefill",))

        def kern():
            return fops.mha(qq, kk, vv, **kw)

        def plain():
            return fref.mha_ref(qq, kk, vv, **kw)

        got = kern()
        want = plain()
        sync()
        err, ratio = check(label, got, want, rtol, atol)
        del got
        faults = {}
        for fault, shift in FLASH_FAULTS.items():
            bad = fref.mha_ref(qq, kk, vv, **dict(
                kw, q_offset=q_offset - shift))
            faults[fault] = excess(bad, want, rtol, atol)
            del bad
        if decode:
            kb, ke, chunk, splits = fref.split_plan(
                1, kk.shape[1], True, window, q_offset, B * K)
            bad = fref.mha_ref(qq, kk, vv, splits=splits, drop=splits // 2,
                               **kw)
            faults["one split dropped"] = excess(bad, want, rtol, atol)
            del bad
            log(f"  flash_attention {label}: plan keys [{kb}, {ke}) in "
                f"{splits} chunks of {chunk}, {B * K * splits} blocks")
            if B * K * splits < 128:
                raise AssertionError(f"flash_attention {label}: "
                                     f"{B * K * splits} decode blocks")
        log(f"  flash_attention {label}: max |err| {err}, {ratio:.4f} of "
            f"the limit (rtol {rtol}, atol {atol}); planted faults "
            f"(max |err|, share of the limit): {faults}")
        for fault, (_err, share) in faults.items():
            if not share > 1.0:
                raise AssertionError(f"flash_attention {label}: the check "
                                     f"passes a fault: {fault} {faults}")
        torch.cuda.empty_cache()
        n = reps if decode else 3
        ms = cuda_ms(kern, n)
        hus = host_us(kern, n)
        seen = set()
        dms = device_ms(kern, n, "flash_attention", names, seen)
        ours = sorted(nm for nm in seen if "flash" in nm)
        if any("flash_kernel" in nm for nm in ours):
            raise AssertionError(f"flash_attention {label}: a bf16 call ran "
                                 f"the f32 kernel: {ours}")
        log(f"  flash_attention {label}: {ms:.4f} ms, device "
            f"{'null' if dms is None else f'{dms:.4f}'} ms, host "
            f"{hus:.2f} us, recorded {ours}")
        pms = cuda_ms(plain, 2)
        pairs = qq.shape[0] * H * _pairs(qq.shape[1], kk.shape[1], window,
                                          q_offset)
        if not decode:  # every q, k, v and o element once
            nbytes = 2 * (2 * qq.numel() + 2 * kk.numel())
        else:  # the live cache rows of k and v, and q and o
            nbytes = 2 * (2 * qq.numel()
                          + 2 * pairs // (H // K) * D)
        rows.append((label, args, window, cap, q_offset, main, want, err,
                     ms, dms, hus, pms, pairs, nbytes, n, ours))

    for (label, (qq, kk, vv), window, cap, q_offset, main, want, err, ms,
         dms, hus, pms, pairs, nbytes, n, ours) in rows:
        if cap > 0.0:
            lib_name = "flex_attention"
            lib = _flex_attention(cap, window, q_offset, qq.shape[1],
                                  kk.shape[1])
        else:
            lib_name = "scaled_dot_product_attention"

            def lib(a, b, c):
                return F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2),
                    c.transpose(1, 2), is_causal=True,
                    enable_gqa=True).transpose(1, 2)
        t = time.time()
        lib_out = lib(qq, kk, vv)
        sync()
        compile_s = time.time() - t
        # the same function: held at the JAX package's bf16 tolerance
        lib_err, _ = check(f"{label} ({lib_name})", lib_out, want,
                           FLASH_TOL["bf16"], FLASH_TOL["bf16"])
        del lib_out
        torch.cuda.empty_cache()
        lib_ms = cuda_ms(lambda: lib(qq, kk, vv), n)
        lib_dms = library_device_ms(lambda: lib(qq, kk, vv), n, lib_name)
        log(f"  flash_attention {label}: {lib_name} {lib_ms:.4f} ms "
            f"(max |err| against plain {lib_err}; first call "
            f"{compile_s:.2f} s)")
        shape = (f"{label}: q {list(qq.shape)} k/v {list(kk.shape)} bf16 "
                 f"window={window} softcap={cap} q_offset={q_offset}, "
                 f"{pairs} live pairs, rtol {rtol} atol {atol}; "
                 f"library_ms: {lib_name}; kernels {ours}")
        record("flash_attention", err, ms, dms, pms, nbytes,
               4 * D * pairs, lib_ms, shape, main, BF16_OPS_PER_S,
               library_device_ms=lib_dms, host=hus, library=lib_name)
    del rows, want
    del q, k, v, qd, kc, vc
    torch.cuda.empty_cache()


def _lm_close(what, card, host, tol):
    """max |card - host| within tol * max(1, max |host|), or raise."""
    c = card.detach().float().cpu()
    h = host.detach().float()
    err = float((c - h).abs().max())
    scale = max(1.0, float(h.abs().max()))
    if c.shape != h.shape or not np.isfinite(err) or err > tol * scale:
        raise AssertionError(f"lm verify {what}: card differs from host "
                             f"(max |err| {err}, scale {scale}, tol {tol})")
    return err


def _lm_verify(cfg, tokens, labels, decode_tokens, tol, full: bool,
               seed: int) -> dict:
    """One config on the card and on the host from the same parameters:
    forward, logits and loss (unless ``full``), prefill, then one decode
    step per column of ``decode_tokens`` into a cache filled from the
    prefill; the card's flash launches per pass."""
    import copy
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    model = T.Transformer(cfg, seed=seed, device=DEVICE)
    host = copy.deepcopy(model).cpu()
    errs, flash = {}, []
    B, S = tokens.shape
    n_dec = decode_tokens.shape[1]
    outs = {}
    for dev, m in ((DEVICE, model), ("cpu", host)):
        tok = torch.from_numpy(tokens).to(dev)
        out = {}
        with torch.no_grad():
            if not full:
                kernels.reset_launches()
                hidden, _aux = T.forward(m, tok)
                if dev == DEVICE:
                    flash.append(kernels.launches()["flash_attention"])
                out["hidden"] = hidden
                out["logits"] = T.logits_fn(m, hidden)
                kernels.reset_launches()
                out["loss"], _ = T.loss_fn(m, {
                    "tokens": tok,
                    "labels": torch.from_numpy(labels).to(dev)})
                if dev == DEVICE:
                    flash.append(kernels.launches()["flash_attention"])
            kernels.reset_launches()
            logits, kv = T.prefill(m, tok)
            if dev == DEVICE:
                flash.append(kernels.launches()["flash_attention"])
            out["prefill"] = logits
            out["prefill_k"] = kv["k"]
            cache = T.make_cache(cfg, B, S + n_dec, device=dev)
            cache["k"][:, :, :S] = kv["k"]
            cache["v"][:, :, :S] = kv["v"]
            del kv
            for j in range(n_dec):
                kernels.reset_launches()
                step = torch.from_numpy(decode_tokens[:, j:j + 1]).to(dev)
                lg, cache = T.decode_step(m, cache, step, S + j)
                if dev == DEVICE:
                    flash.append(kernels.launches()["flash_attention"])
                out[f"decode{j}"] = lg
            out["cache_k"] = cache["k"]
            out["cache_v"] = cache["v"]
        outs[dev] = out
    for key in outs["cpu"]:
        errs[key] = _lm_close(f"{cfg.name} {key}", outs[DEVICE][key],
                              outs["cpu"][key], tol)
    if any(n != cfg.num_layers for n in flash):
        raise AssertionError(f"lm verify {cfg.name}: flash launches per "
                             f"pass {flash}, expected {cfg.num_layers}")
    return dict(errs=errs, flash=flash)


def lm_verify_phase(seed: int) -> dict:
    """The card against the host, f32 on both: the smoke configs of the
    three dense archs (forward, logits, loss, prefill and 4 decode steps
    past the window of 8), and gemma2-2b at full width and depth 2 (one
    local, one global layer) on one 4,160-token request (prefill and 2
    decode steps), so the 4096 window masks early keys.  Returns the
    kernel launches."""
    import dataclasses
    import torch
    from repro_torch.data.synthetic import TokenStream
    totals = {}

    def add(flash):
        totals["flash_attention"] = totals.get("flash_attention", 0) \
            + sum(flash)

    for arch in LM_SMOKE_ARCHS:
        cfg = _lm_arch(arch).smoke_config
        b = TokenStream(cfg.vocab, 2, 28, seed).batch_at(0)
        t = time.time()
        out = _lm_verify(cfg, b[:, :24], b[:, 1:25], b[:, 24:28],
                         LM_SMOKE_TOL, False, seed)
        add(out["flash"])
        log(f"  lm verify {cfg.name}: max |card - host| "
            f"{json.dumps(out['errs'])}, flash launches {out['flash']} "
            f"({time.time() - t:.2f} s)")
    full = _lm_arch("gemma2-2b").full_config
    cfg = dataclasses.replace(full, name="gemma2-2b-depth2", num_layers=2,
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    b = TokenStream(cfg.vocab, 1, 4162, seed).batch_at(0)
    t = time.time()
    out = _lm_verify(cfg, b[:, :4160], None, b[:, 4160:4162], LM_FULL_TOL,
                     True, seed)
    add(out["flash"])
    log(f"  lm verify {cfg.name} (full width, 4,160 tokens): max |card - "
        f"host| {json.dumps(out['errs'])}, flash launches {out['flash']} "
        f"({time.time() - t:.2f} s)")
    return totals


def lm_serve_phase(seed: int) -> dict:
    """gemma2-2b at full width and depth (26 layers, bf16 parameters and
    activations, random parameters drawn on the card from ``seed``): 4
    requests of 8,192-token prompts (TokenStream), prefill, then 32 greedy
    decode steps into an 8,224-row cache filled from the prefill's k/v;
    SERVE_ROUNDS rounds (1 cold), one profiled prefill and one profiled
    decode step.  The first decode step's logits are held against a
    prefill of the prompt and that step's token.  Returns the launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    cfg = _lm_arch("gemma2-2b").full_config
    B, S, n_dec = SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = T.Transformer(cfg, seed=seed, device=DEVICE)
    sync()
    init_s = time.time() - t
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(
        TokenStream(cfg.vocab, B, S, seed).batch_at(0)[:, :S]).to(DEVICE)
    totals = {"flash_attention": 0}
    prefill_ms, step_ms, per_prefill, per_step = [], [], [], []
    generated = None

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        n = kernels.launches()["flash_attention"]
        totals["flash_attention"] += n
        return out, n

    for r in range(SERVE_ROUNDS):
        sync()
        t = time.time()
        (logits, kv), n = counted(lambda: T.prefill(model, prompt))
        sync()
        prefill_ms.append((time.time() - t) * 1e3)
        per_prefill.append(n)
        cache = T.make_cache(cfg, B, S + n_dec, device=DEVICE)
        cache["k"][:, :, :S] = kv["k"]
        cache["v"][:, :, :S] = kv["v"]
        del kv
        tok = logits.argmax(-1)[:, None]
        toks, first = [tok], None
        for j in range(n_dec):
            sync()
            t = time.time()
            (lg, cache), n = counted(
                lambda: T.decode_step(model, cache, tok, S + j))
            tok = lg.argmax(-1)[:, None]
            sync()
            if r > 0:
                step_ms.append((time.time() - t) * 1e3)
            per_step.append(n)
            toks.append(tok)
            if j == 0:
                first = lg
        if not torch.isfinite(lg.float()).all():
            raise AssertionError("lm serve: non-finite decode logits")
        gen_r = torch.cat(toks, 1).cpu().numpy()
        if generated is not None and not np.array_equal(gen_r, generated):
            raise AssertionError("lm serve: greedy tokens differ between "
                                 "rounds")
        generated = gen_r
        log(f"  lm serve round {r}: prefill {prefill_ms[-1]:.2f} ms, "
            f"decode {n_dec} steps")
    del cache
    torch.cuda.empty_cache()

    # decode against prefill at full depth: the first decode step (the
    # token at position S) against the last row of a prefill of S + 1
    # tokens; both bf16 on the card, with other matmul shapes (4 rows
    # against 4 x 8,193) and so other roundings through 26 layers
    ext = torch.cat([prompt, torch.from_numpy(generated[:, :1]).to(DEVICE)],
                    1)
    (want, kv), n = counted(lambda: T.prefill(model, ext))
    per_prefill.append(n)
    del kv
    err = float((first.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    agree = float((first.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  lm serve: decode at position {S} against prefill of {S + 1}: "
        f"max |err| {err} of max |logit| {scale}, argmax agreement {agree}")
    if not err <= LM_DECODE_TOL * scale:
        raise AssertionError(f"lm serve: decode differs from prefill "
                             f"(max |err| {err}, scale {scale})")

    # one profiled prefill and decode step, through the bf16 prefill kernel
    # and the decode split and combine; a pass whose records the profiler
    # lost (a flash kernel missing among them) is profiled again
    prefill_names = ("flash_prefill",)
    step_names = ("flash_decode_split", "flash_decode_combine")

    def profiled(fn, want, counts):
        for attempt in range(1, 4):
            names = {}
            res, n = counted(lambda: idle_share(
                fn, names, {"flash_attention": len(want)}))
            counts.append(n)
            if all(any(w in nm for nm in names) for w in want):
                break
        log(f"  lm serve: profiled pass recorded {want} on attempt "
            f"{attempt}")
        return res, names

    (wall, busy, idle, rec, exp), by_name = profiled(
        lambda: T.prefill(model, prompt), prefill_names, per_prefill)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    cache = T.make_cache(cfg, B, S + n_dec, device=DEVICE)
    (dwall, dbusy, didle, drec, dexp), dec_by = profiled(
        lambda: T.decode_step(model, cache, tok, S), step_names, per_step)
    dtop = sorted(dec_by.items(), key=lambda kv: -kv[1][1])[:6]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  lm serve: profiled prefill {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {idle} ({rec} of {exp} kernel "
        f"launches recorded); device time by kernel (launches, ms):")
    for name, (cnt, ms) in top:
        log(f"    {ms:10.3f} ms {cnt:5d}x {name}")
    log(f"  lm serve: profiled decode step {dwall * 1e3:.2f} ms, device "
        f"busy {dbusy * 1e3:.2f} ms, idle share {didle}; by kernel:")
    for name, (cnt, ms) in dtop:
        log(f"    {ms:10.3f} ms {cnt:5d}x {name}")
    for what, names, want in (("prefill", by_name, prefill_names),
                              ("decode step", dec_by, step_names)):
        found = [nm for nm in names if "flash" in nm]
        if any("flash_kernel" in nm for nm in found) or not all(
                any(w in nm for nm in found) for w in want):
            raise AssertionError(f"lm serve: the {what} ran {found}, "
                                 f"expected {want}")
    if any(x != cfg.num_layers for x in per_prefill + per_step):
        raise AssertionError(f"lm serve: flash launches per prefill "
                             f"{per_prefill}, per decode step "
                             f"{sorted(set(per_step))}, expected "
                             f"{cfg.num_layers}")
    steps = np.asarray(step_ms)
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, params=n_params,
        init_s=init_s, batch=B, prompt=S, decode_steps=n_dec,
        rounds=SERVE_ROUNDS, prefill_first_ms=prefill_ms[0],
        prefill_warm_ms=prefill_ms[1:],
        prefill_warm_p50_ms=float(np.percentile(prefill_ms[1:], 50)),
        decode_step_p50_ms=float(np.percentile(steps, 50)),
        decode_step_p99_ms=float(np.percentile(steps, 99)),
        decode_tokens_per_s=float(B * len(steps) / steps.sum() * 1e3),
        peak_mem_gib=peak, prefill_profiled_ms=wall * 1e3,
        prefill_device_busy_ms=busy * 1e3, prefill_idle_share=idle,
        prefill_launches_recorded=[rec, exp],
        decode_profiled_ms=dwall * 1e3, decode_device_busy_ms=dbusy * 1e3,
        decode_idle_share=didle, decode_launches_recorded=[drec, dexp],
        decode_vs_prefill_err=err, decode_vs_prefill_scale=scale,
        flash_per_prefill=per_prefill[0], flash_per_step=per_step[0],
        prefill_top_kernels_ms={n: ms for n, (_c, ms) in top},
        launches=totals)
    log("  lm serve: " + json.dumps(out))
    return totals


SOURCES = {
    "signed_member": ("src/repro_torch/csrc/intersect.cu",
                      "src/repro/kernels/intersect/intersect.py:235"),
    "fused_extend": ("src/repro_torch/csrc/extend.cu",
                     "src/repro/kernels/extend/extend.py:274"),
    "rank_lt_le": ("src/repro_torch/csrc/merge_rank.cu",
                   "src/repro/kernels/merge/merge.py:144"),
    "commit_fold": ("src/repro_torch/csrc/fold.cu",
                    "src/repro/kernels/merge/fold.py:244"),
    "member": ("src/repro_torch/csrc/intersect.cu",
               "src/repro/kernels/intersect/intersect.py:155"),
    "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_ops/segment_ops.py:54"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:92"),
}


def parse_cell(text: str):
    """``SCALE:query,query[@EPOCHS[/BATCH]]`` -> (scale, [queries], epochs
    or None for the phase's default, update batch or None for
    ``--update-batch``)."""
    cell, _, depth_ = text.partition("@")
    scale, queries = cell.split(":")
    epochs, _, batch = depth_.partition("/")
    return (int(scale), queries.split(","), int(epochs) if epochs else None,
            int(batch) if batch else None)


def random_relation(n: int, arity: int, nv: int, seed: int) -> np.ndarray:
    """``n`` random distinct rows of ``arity`` ids below ``nv`` (sorted)."""
    from repro_torch.core.delta import _unique_rows
    rng = np.random.default_rng(seed + 11)
    rows = _unique_rows(rng.integers(0, nv, (n, arity)).astype(np.int32))
    while rows.shape[0] < n:  # top up the few collisions
        more = rng.integers(0, nv, (n - rows.shape[0], arity))
        rows = _unique_rows(np.concatenate([rows, more.astype(np.int32)]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", action="append", type=parse_cell,
                    help="a serve cell SCALE:query,query[@EPOCHS[/BATCH]] "
                    "(repeatable, 20 epochs unless given); default "
                    "16:triangle,diamond@6, 20:triangle@20 and "
                    "14:triangle,4-clique-tri@7")
    ap.add_argument("--verify", action="append", type=parse_cell,
                    help="a verify cell SCALE:query,query[@EPOCHS[/BATCH]] "
                    "(repeatable, 8 epochs unless given); default "
                    "9:triangle,diamond@8, 14:triangle@6, "
                    "9:triangle,4-clique,4-clique-tri@8 and "
                    "8:4-clique,5-clique,5-clique-quad@8/64")
    ap.add_argument("--update-batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # diamond's epochs at scale 16 take 9-20 s each on the host-bound
    # BiGJoin loop and the triangle oracle at scale 14 seconds per epoch,
    # so those cells run fewer epochs to keep the whole script well inside
    # its time limit on a slow host
    cells = args.serve or [(16, ["triangle", "diamond"], 6, None),
                           (20, ["triangle"], 20, None),
                           (14, ["triangle", "4-clique-tri"], 7, None)]
    checks = args.verify or [
        (9, ["triangle", "diamond"], 8, None), (14, ["triangle"], 6, None),
        (9, ["triangle", "4-clique", "4-clique-tri"], 8, None),
        (8, ["4-clique", "5-clique", "5-clique-quad"], 8, 64)]

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    # f32 matmuls in full f32 (the defaults, stated): the train phases
    # hold the card's steps to the host's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import VARIANTS, _build
    from repro_torch.data.synthetic import rmat_graph

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"  device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}"
            f" cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    with phase("build"):
        t = time.time()
        logs = _build.build(force=True)
        for name, text in logs.items():
            # per entry function: registers and bytes of spill stores
            entries, spill, fn = [], None, None
            for ln in text.splitlines():
                if "Compiling entry function" in ln:
                    fn = ln.split("'")[1]
                elif "spill stores" in ln:
                    spill = ln.split("bytes spill stores")[0].split(",")[-1]
                elif "Used" in ln and "registers" in ln and fn:
                    regs = ln.split("Used")[1].split("registers")[0]
                    entries.append(f"{fn} {regs.strip()} regs "
                                   f"{spill.strip()} B spilled")
                    fn = None
            log(f"  {name}: " + " | ".join(entries))
        log(f"  built {sorted(logs)} in {time.time() - t:.2f} s")

    graphs = {}
    built = {}  # n-ary relation -> (graph, rows, seconds), see relation_rows
    with phase("graph"):
        for scale in sorted({c[0] for c in cells}):
            graphs[scale] = rmat_graph(scale, 16, seed=args.seed)
            log(f"  rmat scale {scale}: |E|={graphs[scale].shape[0]}")

    with phase("kernels"):
        top = max(graphs)
        table = kernel_phase(graphs[top], 1 << top, args.update_batch,
                             16 * args.update_batch, args.reps, args.seed)
        tri_edges = graphs.get(TRI_SCALE)
        if tri_edges is None:
            tri_edges = rmat_graph(TRI_SCALE, 16, seed=args.seed)
        tri, secs = relation_rows(tri_edges, "tri", built)
        quad = random_relation(QUAD_ROWS, 4, 1 << 12, args.seed)
        log(f"  composite: tri of scale {TRI_SCALE} = {tri.shape[0]} rows "
            f"(enumerated on the card in {secs:.2f} s), random quad rows = "
            f"{quad.shape[0]}")
        table.update(kernel_phase_lex(
            tri, quad, rmat_graph(12, 16, seed=args.seed),
            args.update_batch, 16 * args.update_batch, args.reps,
            args.seed))
        del tri, quad
        flash_rows(table, args.reps, args.seed)

    # every session and training run below starts its kernel counts at 0
    # and reads them after; the table's launches sum them over these runs
    launches = {name: 0 for name in VARIANTS}
    for scale, queries, epochs, batch in checks:
        with phase(f"verify {scale}:{','.join(queries)}"):
            counts = verify_phase(scale, queries, epochs or 8,
                                  batch or args.update_batch, args.seed)
            for name in VARIANTS:
                launches[name] += counts[name]

    for scale, queries, epochs, batch in cells:
        with phase(f"serve {scale}:{','.join(queries)}"):
            edges = graphs[scale]
            ub = batch or args.update_batch
            ratio = 8 * ub / edges.shape[0]
            if nary_relations(queries):
                serve = serve_nary_phase(edges, 1 << scale, queries,
                                         epochs or 20, ub, ratio, args.seed,
                                         built)
            else:
                serve = serve_phase(edges, 1 << scale, queries, epochs or 20,
                                    ub, ratio, args.seed)
            for name in VARIANTS:
                launches[name] += serve["launches"][name]

    # the GNN training path, segment_sum's kernel rows from the full-width
    # phase at the trainer's shape; then the LM serving path
    for label, run in (
            ("train driver", lambda: train_driver_phase(args.seed)),
            ("train full", lambda: train_full_phase(table, args.reps,
                                                    args.seed)),
            ("train archs", lambda: train_archs_phase(args.seed)),
            ("lm verify", lambda: lm_verify_phase(args.seed)),
            ("lm serve gemma2-2b", lambda: lm_serve_phase(args.seed))):
        with phase(label):
            counts = run()
            for name in VARIANTS:
                launches[name] += counts.get(name, 0)

    rows = []
    for name in VARIANTS:
        r = table[name]
        src, replaces = SOURCES[name.removesuffix("_lex")]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=int(launches[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], host_us=r["host_us"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"],
            library=r["library"], shape=r["shape"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
