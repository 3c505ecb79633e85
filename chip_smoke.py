#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each printed with its result and seconds.  They run in this
order: 1 and 2; then 11, 13-17 and phase 20's card cells, which need no
graph, while the R-MAT graphs are made on the host (``graph`` waits for
what is left); then 3-10, 12, 18 and 19 (21 only with ``--ranks-only``):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — compile the CUDA kernels from ``src/repro_torch/csrc`` (the
              R-MAT graphs made on the host meanwhile, ``graph``);
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
              sentinel queries, queries past either end), and fused
              extend and merge ranks at theirs (resumed cursors, a budget
              cut mid-row, rows without extensions, every row invalid, B'
              above the total, argmin ties, a budget cumsum that wraps;
              unsorted queries, entries held twice), and the commit fold
              in both forms (``in_ba``, and ``base`` probed inside the
              launch, timed against the rank probe it replaced) at its
              edge inputs (udel empty, n = capacity, every cins entry
              deleted, uins inside cins, udel absent from base, a cins
              capacity below the union, a one-block grid) at delta
              capacities of 2,048, 8,192 and 32,768; one CUDA graph
              capture of fused extend, merge ranks and both fold forms,
              replayed against eager calls (``--graph-check``, a process
              of its own); then the flash-attention kernels against
              their plain version at the JAX package's six sweep shapes
              (f32 and bf16), at bf16 rows
              without a live key and a decode plan with masked chunks and
              chunks past the cache, and at gemma2-2b's serving shapes
              (bf16 prefill on the tensor-core kernel and decode split over
              the cache, local and global layers) with planted faults
              (an edge off by a key or a key tile, a decode chunk dropped)
              the check must reject, with compiled flex_attention's or
              scaled_dot_product_attention's time beside them; the
              composite rows, their edge checks, the graph check and the
              flash rows run after phase 4 (``kernels composite``), the
              ``tri`` relation they read enumerated on the card while the
              verify cells run;
4. verify   — a GraphSession over dirty update epochs, one cell per
              (scale, queries), each cell in a process of its own
              (``--verify-only``), all started together, and beside them
              the kernel-coverage gate (``launch.kernel_coverage``: no
              compile after the admission prewarm, one commit-fold launch
              per relation, composite ``tri`` included, and a probe
              launch), a process too, and the mesh's harnesses and
              drivers at w = 4 (``_delta_dist_check``,
              ``_nary_dist_check``, ``run_query --mode distributed
              --verify``, ``_serve_check --workers 4 --chaos`` with
              ``dist.program`` faults; and ``_serve_check``'s modes A,
              B (``--supervise``, a job killed right after a WAL append
              and resumed) and C (``--chaos`` over rank-0 and all-rank
              fault points) with the pool at w = 4 over R = 2 gloo ranks
              of ``torch.distributed.run``, every rank on the card), and
              phase 20's wcoj smoke run, each a process that must exit 0
              with its exact line; the mesh across processes at a small
              size (a uniform graph of 16,384 edges, w = 4, B' 1,024):
              ``_dist_check`` plain and ``--balance`` and
              ``_delta_dist_check`` (4 epochs) as one process and as R =
              2 and R = 4 ranks (see 21), a case at a time in a thread,
              each ranked run held field for field to the one process
              (count, counters, steps, loads, the tuples in worker order,
              each epoch's signed delta), each rank's device bytes 1/R of
              its, each rank's launches of the case's kernels, a ``mesh
              ranks:`` line a run (bytes and exchange ms a step, not
              compared: they share the host with the cells); each epoch's
              signed delta equal to the numpy oracle (full
              recomputation), compaction included.  A cell
              naming an n-ary query (``4-clique-tri``, ``5-clique-quad``)
              materialises its relation from the feeding query
              (``triangle``, ``4-clique``), feeds it that query's delta every
              epoch, and holds the n-ary query to its edge-only twin too;
5. serve    — the same session at realistic graph sizes, one cell per
              (scale, queries): warm per-epoch latency, peak device memory,
              each kernel's launch count (every kernel of the cell's path
              must launch; merge ranks at least three times a
              compaction, 1-word and composite apart) and the device idle
              share of one profiled warm
              epoch;
6. txn      — transactions at the serve 20:triangle cell's size: session
              A runs 4 epochs, its snapshot goes through the port's
              checkpoint under ``build/`` and is restored into session B
              (built over 1,024 edges; every restored tensor on the card),
              then A and B run 4 epochs in lockstep, deltas bit for bit, B
              on the session kernels, and end with equal snapshots; a
              fault at a projection fold and one at normalize leave A
              equal to its pre-epoch snapshot and the retried batch gives
              B's delta; the same restore and lockstep on a composite
              session (scale 12, triangle,4-clique-tri, ``lo`` leaves and
              a derived projection, B on the ``_lex`` kernels); §5.4 on the
              card (tri rows and 4-cliques through tri at scale 11 against
              the host oracle, at scale 12 against a static symmetric
              4-clique count on the card); and the public folds of ``csr``
              on the card against the same calls on CPU copies, bit for
              bit, over the scale-18 edge set and the scale-14 ``tri``
              rows, at a capacity below the union too;
7. pool     — serving: four tenants (R-MAT scale 18 each) on one
              ``SessionPool(device="cuda")`` with a fsynced WAL and a
              snapshot every 4 epochs under ``build/pool``; three take
              6 timed dirty batches of 2,048 at coalesce 1, one bursts of 8
              clean batches of 256 at coalesce 8; every epoch's delta
              equal to an isolated session's fed the batches the
              tenant's WAL logged, every session kernel launched by the
              apply thread alone, no compile event after admission; one
              tenant recovered from its directory (snapshot + WAL) equal
              to the uninterrupted one; updates/s, apply and prep ms,
              queue depth, restore and replay seconds, peak memory and
              the idle share of a profiled window; and, in processes of
              their own, ``_serve_check --supervise`` and ``--chaos``,
              ``launch.serve`` (stream, concurrent, gemma2-2b, and the
              stream over 2 gloo ranks with a snapshot every 2 epochs,
              ``--backend gloo``) and ``launch.run_query --mode delta``;
8. examples — every ``examples/torch_*.py`` twin in a process of its own
              on the card (the LM twin 40 steps): exit 0 and its "✓"
              lines;
9. mesh     — the paper's distributed dataflow with w = 4 workers as a
              leading tensor axis on the card (``core.distributed``,
              BiGJoin-S aggregation, deferral and Balance): triangle,
              triangle balanced and 4-clique-tri over ``tri`` at R-MAT
              scale 10, and 5-clique-quad over ``quad`` of scale 6
              (composite keys, the ``_lex`` membership kernel), each bit
              for bit the host's (every counter, each worker's tuples and
              weights in order) and the single-device count; then the
              triangle count at scale 14, B' 65,536 a worker, plain and
              balanced, equal to the single-device engine's, every shard
              entry owned once: seconds, steps, loads, member launches,
              peak memory, the idle share of a profiled step;
10. mesh stream — Delta-BiGJoin on the worker-sharded store (the paper's
              §4, memory split w = 4 ways), mesh ``GraphSession``s on the
              card: (a) triangle and diamond at R-MAT scale 10, 4 epochs
              of 256 dirty updates, plain and balanced, and the §5.4 pair
              at scale 9 (triangle feeding ``tri``, 4-clique-tri over it),
              each bit for bit the same session's on the host (a spawned
              process each, beside the card's): every epoch's tuples and
              weights in order, count_delta and the final snapshot; one
              launch of the commit fold's worker axis a relation or
              projection fold and epoch (``commit_fold_lex_w`` for
              ``tri``); (b) triangle on the scale-18 graph at w = 4 (B'
              and route from ``auto_sizing``), 6 epochs of 2,048 plain,
              then the snapshot restored into a balanced session for 3
              more, every epoch's canonical delta equal to the one-device
              session's on the card, every shard entry owned once: epoch
              p50/p99, steps, launches an epoch, live entries a worker,
              peak memory, the idle share of a profiled epoch; and the
              kernel rows of the fold's worker axis (``commit_fold_w``
              over that store's projection, ``commit_fold_lex_w`` over the
              ``tri`` store of (a)) at those shapes, one worker's delta
              empty, bit for bit the plain version on host copies, timed
              against w launches of the one-region kernel on the shards;
11. train driver — ``repro_torch.launch.train`` with --arch gatedgcn and
              with --arch mixtral-8x7b (its smoke config) at their
              defaults, each to step 10, relaunched to step 20: it resumes
              from its checkpoint and ends with a finite loss;
12. train full — GatedGCN at full width (16 layers, d 70, the minibatch_lg
              shape) on a 232,965-node graph: triangle features from the
              port's BiGJoin on the card, sampled union graphs, the
              segment_sum kernel against its plain version at that shape
              (f32, f16, unsorted; random rows on the padding hub and all
              rows in one segment against float64; two calls bitwise
              equal), the first step against the host's (the host's in
              a thread beside the card's steps), then 5 steps: step ms,
              peak memory, idle share of a profiled step, 2 segment_sum
              launches per layer and step;
13. train archs — one step of each GNN arch at smoke width and of a
              graph_reg batch, the card's loss against the host's;
14. train recsys — the two-tower model: one smoke step against the host
              (loss, gradient norm), then full width (10M, 1M and 100k-row
              tables, 1M items, embed 256, towers 1024-512-256, f32, the
              EmbeddingBag through segment_sum): 5 steps of 65,536 events,
              step ms, peak memory, idle share of a profiled step, then
              serve_p99 (512 events) and one query against 1,000,000
              candidates (top 100);
15. lm verify — the LM transformer on the card against the host, f32 on
              both: the five archs' smoke configs (forward and loss through
              ``_attend`` with no flash launch; prefill and 4 decode steps
              with one a layer), gemma2-2b at full width and depth 2 on a
              4,160-token request and mixtral-8x7b (MoE) at full width and
              depth 1 on a 520-token request (prefill, 2 decode steps);
16. lm train verify — ``make_train_step`` on the card against the host,
              f32, the five archs' smoke configs at 1 and 2 microbatches:
              two steps, each loss and gradient norm, every parameter and
              AdamW moment after; no flash launch;
17. lm train mixtral-8x7b — full width (8 experts top-2), depth 2, bf16,
              8 sequences of 4,096 tokens in 4 microbatches: the first
              microbatch's bf16 loss against f32, the share of assignments
              each layer keeps, 6 steps and one profiled: step ms, tokens/s,
              peak memory, idle share; finite losses and gradient norms;
18. lm serve gemma2-2b — full width and depth, bf16, random parameters
              from the seed: 4 prompts of 8,192 tokens, prefill and 32
              greedy decode steps, 3 rounds (1 cold) and one profiled
              prefill and decode step; decode held against prefill; 26
              flash launches per prefill and per decode step;
19. lm serve mixtral-8x7b — the same at full width, depth 12, on 4
              prompts of 4,096 tokens: 12 flash launches a pass, the warm
              rounds' tokens equal, the kept share of each layer;
20. dryrun  — the dry run (``launch.dryrun --mesh both``: every arch x
              shape x production mesh on meta tensors, a process that
              sees no card), the meta counts of this phase's card cells
              (``--dryrun-meta``, a process that sees no card either) and
              ``launch.train --arch wcoj-subgraph`` (the distributed
              triangle count on one worker held to Generic Join's,
              membership launches above 0); the first two start beside
              the build, the third beside the verify cells, and the dry
              run and the wcoj run are checked when the verify cells
              end: 88 records, no error, the registry's skipped cells;
              the card cells, run after phase 17: gemma2-2b's
              train_4k (batch 4) and prefill_32k (batch 1) cells at depth
              2 on the card against the same cells on meta: equal FLOPs
              (FlopCounterMode plus the flash kernel's operations), equal
              output shapes, the flash calls' operations equal the meta
              counter's, the allocator's peak beyond the arguments within
              64 MiB + 2 % of the meta peak; and segment_sum's scratch
              size against the library's.
21. mesh ranks (``--ranks-only``: the build, then this phase; not in the
              default run, whose limit has no room for its 220-330 s) —
              the mesh across processes, each run alone on the card and
              the host: ``_dist_check`` (the triangle join of the
              mesh phase's scale-14 graph at its B' of 65,536 a worker,
              its 4,506,715 tuples collected) and ``_delta_dist_check``
              (4 epochs of 2,048 updates on that graph, B' 512) at w = 4,
              as one process on the card, then as R = 2 and R = 4 ranks
              of ``torch.distributed`` under ``torch.distributed.run``
              (gloo, every rank on the card; NCCL, one rank a card, where
              the machine has two cards or more); the one process's count
              and tuples held to Generic Join's, each ranked run field for
              field to it (count, counters, steps, loads, the tuples in
              worker order, each epoch's signed delta), each rank's device
              bytes of index and store 1/R of its, each rank's launches of
              the case's kernels; a ``mesh ranks:`` line a run gives the
              bytes a rank sends and the exchange's ms a step (an epoch),
              the seconds to the count (of the epochs) against one process
              and the exchange's share of them, every exchange timed
              between two device synchronisations in every run, one
              process's included; then the durable pool across ranks at
              size (``ranks_serve_phase``): two tenants of R-MAT scale
              18 at w = 4, 6 epochs of 2,048 dirty updates and a
              snapshot every 4, as one process, as R = 2 ranks (gloo;
              NCCL too with two cards), the R = 2 job killed right after
              t1's WAL append of epoch 5 and resumed: every epoch's delta
              and the final state (edges, every leaf of the gathered
              snapshot) equal to one process's, with snapshot gather,
              restore scatter and replay seconds, apply ms p50 against
              one process, the bytes a rank sends for the snapshots and
              each rank's device bytes (half of one process's).

The second-to-last lines are the kernel table as one JSON object and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
non-zero and no result line is printed.  Needs one CUDA device; run from the
repository root: ``python3 chip_smoke.py [--serve 16:triangle,diamond@10]``;
``--ranks-only`` runs the build and phase 21 alone, and no result line.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# the card's peaks, one source for the bounds here and the dry run
from repro_torch.launch.mesh import (BF16_OPS_PER_S,  # noqa: E402
                                     HBM_BYTES_PER_S, SCALAR_OPS_PER_S)

DEVICE = "cuda"
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
    "fused_extend": ("extend_kernel",),
    "rank_lt_le": ("rank_kernel",),
    "commit_fold": ("fold_kernel",),
}


def kernel_of(variant: str) -> str:
    """The kernel of a launch name: ``commit_fold_lex_w`` ->
    ``commit_fold`` (``kernels.VARIANTS_OF``)."""
    return variant.removesuffix("_w").removesuffix("_lex")


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
    names = names or KERNEL_FUNCS[kernel_of(kernel)]
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
    expected = sum((after[k] - before[k]) * per_call[kernel_of(k)]
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
    return dict(run=run, full=full, empty=empty, full_rows=full_rows,
                run_key=run_rows[0, :ar - 1], build=build,
                queries=(tq, tl, tv))


# the lane counts a search of fused extend can take (extend_dispatch in
# csrc/extend.cu): the edge checks must reach each of them
EXTEND_LANES = (1, 2)
# commit fold grid size -> the edge checks that took it (fold_edge_checks):
# they must reach a one-block grid and a larger one
FOLD_GRIDS: dict = {}
# the delta capacities of the commit fold's edge checks: an epoch's update
# batch, up to a relation's deltas (serve 14's `tri` removes ~20,000 rows
# an epoch)
FOLD_DELTA_CAPS = (2048, 8192, 32768)


def extend_rank_edge_checks(big, rows: np.ndarray, edge: dict, label: str,
                            seed: int) -> None:
    """Fused extend and merge ranks at their edge cases, full size (W =
    B' = 8192 for extend, whole regions of up to 2^24 entries as rank
    queries), kernel against plain version exactly.  ``big`` and ``rows``
    as for member_edge_checks, ``edge`` its regions.  Extend: resumed
    cursors (wk > 0), a budget exhausted in the middle of a row (the
    100,000-entry run), rows with no extension between live rows, every
    row invalid, B' above the total (slots past it clip to W - 1), argmin
    ties (two equal bindings), regions with n = 0 and n = capacity, an
    int32 cumsum of the budget that wraps (8192 rows of 2^20 extensions
    each), and the mixed case at the sessions' other windows, W = B' =
    1024, 2048 and 4096; together they must reach every lane count a
    search can take (EXTEND_LANES), each case's logged.  Ranks: a sorted
    region against another, unsorted queries, a region with a key run
    against itself, a region holding every entry twice against itself,
    sentinel queries and queries past either end (int64 queries of a
    narrow region), n = 0 and n = capacity."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.extend import ops as eops, ref as eref
    from repro_torch.kernels.merge import ops as mops, ref as mref
    dev = big.key.device
    rng = np.random.default_rng(seed + 31)
    run, full, empty = edge["run"], edge["full"], edge["empty"]
    ar = rows.shape[1]
    composite = ar > 2
    nv = int(rows.max()) + 1
    W = 8192

    def window_keys(pre):
        """The lookup keys of window prefixes ``pre`` [W, ar - 1]."""
        if composite:
            from repro_torch.core import csr
            hi, lo = csr.pack_key(tuple(pre[:, c] for c in range(ar - 1)))
            return (torch.from_numpy(hi).to(dev, big.key.dtype),
                    torch.from_numpy(lo).to(dev))
        return torch.from_numpy(pre[:, 0].copy()).to(dev, big.key.dtype)

    lanes = {}  # case -> lanes a search the kernel took

    def check_extend(what, pos, neg, qks, wk, valid, Bp):
        got = eops.fused_extend(pos, neg, qks, wk, valid, Bp)
        want = eref.fused_extend_ref(pos, neg, qks, wk, valid, Bp)
        sync()
        max_abs_err(got, want)
        lanes[what] = _build.lib("extend").repro_extend_lanes(
            sum(len(p) + len(n) for p, n in zip(pos, neg)), wk.shape[0],
            int(composite))
        return want

    # live prefixes, the run's key, absent keys (no extension), mixed
    pre = np.concatenate([
        rows[rng.integers(0, rows.shape[0], W // 2), :ar - 1],
        np.repeat(edge["run_key"][None], W // 8, 0),
        np.full((W // 8, ar - 1), nv + 7, np.int32),
        rng.integers(0, nv, (W - W // 2 - W // 4, ar - 1)).astype(np.int32)])
    pre = pre[rng.permutation(W)]
    qk = window_keys(pre)
    wk = torch.from_numpy(rng.integers(0, 4, W).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(W) < 0.9).to(dev)
    out = {}
    mpos, mneg = [(big, run, full), (big, empty)], [(empty, run), (full,)]
    want = check_extend("mixed", mpos, mneg, [qk, qk], wk, valid, W)
    out["mixed proposals"] = int(want[5][0])
    out["rows cut by the budget"] = int((~want[4] & valid & (want[3] > 0))
                                        .sum())
    # the other windows the sessions run (W = B' of 1024 to 4096; serve
    # 20:triangle's 4096 among them), 5 + 3 regions as row 3
    for Ws in (1024, 2048, 4096):
        qs = window_keys(pre[:Ws])
        check_extend(f"W={Ws}", mpos, mneg, [qs, qs], wk[:Ws], valid[:Ws],
                     Ws)
    want = check_extend("ties", [(big,), (big,)], [(), ()], [qk, qk], wk,
                        valid, W)
    out["ties proposals"] = int(want[5][0])
    check_extend("invalid", [(big, run)], [(empty,)], [qk], wk,
                 torch.zeros(W, dtype=torch.bool, device=dev), W)
    fpre = edge["full_rows"][rng.integers(0, edge["full_rows"].shape[0], W),
                             :ar - 1]
    fvalid = torch.arange(W, device=dev) < 16
    want = check_extend("under budget", [(full,)], [(empty,)],
                        [window_keys(fpre)], torch.zeros_like(wk), fvalid, W)
    if not int(want[5][0]) < W:
        raise AssertionError(f"{label}: the under-budget case proposes "
                             f"{int(want[5][0])} of {W}")
    out["under budget proposals"] = int(want[5][0])
    one_rows = np.repeat(rows[:1], 1 << 20, 0)
    one_rows[:, ar - 1] = np.arange(1 << 20)
    one = edge["build"](one_rows, 1 << 20)
    opre = np.repeat(rows[:1, :ar - 1], W, 0)
    want = check_extend("wrap", [(one,)], [()], [window_keys(opre)], wk,
                        torch.ones(W, dtype=torch.bool, device=dev), W)
    out["wrap rows allowed"] = int((want[3] > 0).sum())
    del one
    if set(lanes.values()) != set(EXTEND_LANES):
        raise AssertionError(f"{label}: the extend edge cases took lanes "
                             f"{lanes}, not every one of {EXTEND_LANES}")

    # -- ranks
    def check_rank(what, r, qk, qv, qlo=None):
        got = mops.rank_lt_le(r.key, r.val, r.n, qk, qv, lo=r.lo, qlo=qlo)
        want = mref.rank_ref(r.key, r.val, r.n, qk, qv, lo=r.lo, qlo=qlo)
        sync()
        max_abs_err(got, want)
        return want

    def twice(r):
        n = int(r.n)
        k = torch.repeat_interleave(r.key[:n], 2)
        v = torch.repeat_interleave(r.val[:n], 2)
        lo = None if r.lo is None else torch.repeat_interleave(r.lo[:n], 2)
        return type(r)(k, v, torch.tensor(2 * n, dtype=torch.int32,
                                          device=dev), lo)

    ranks = {}
    for what, r, q in (("sorted", big, full), ("n=cap", full, big),
                       ("n=0", empty, full), ("run self", run, run)):
        want = check_rank(what, r, q.key, q.val, q.lo)
        ranks[what] = int((want[1] > want[0]).sum())
    perm = torch.randperm(big.capacity, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    want = check_rank("unsorted", full, big.key[perm], big.val[perm],
                      None if big.lo is None else big.lo[perm])
    ranks["unsorted"] = int((want[1] > want[0]).sum())
    tw = twice(full)
    want = check_rank("twice self", tw, tw.key, tw.val, tw.lo)
    ranks["twice self"] = int((want[1] - want[0]).max())
    tq, tl, tv = edge["queries"]
    for what, r in (("edge queries big", big), ("edge queries run", run)):
        check_rank(what, r, tq.to(torch.int64), tv, tl)
        order = torch.argsort(tq.to(torch.int64), stable=True)
        check_rank(what + " sorted", r, tq.to(torch.int64)[order], tv[order],
                   None if tl is None else tl[order])
    log(f"  extend and rank edge cases {label}: W=B'={W} (and 1024-4096), "
        f"run region n={int(run.n)}, n=cap={int(full.n)}, n=0: exact; "
        f"lanes a search {lanes}; {out}; ranks "
        f"(queries with le > lt, or the largest le - lt) {ranks}")


def fold_work(regs, cc, base=None):
    """(bytes, operations) of one commit fold into outputs of capacity
    ``cc``: the live entries of its four regions and their counts read,
    both outputs written whole (their padding included) and their counts;
    the ``in_ba`` form reads udel's bits, the base form searches base for
    udel's live rows (``search_bytes``).  Operations: a search of the
    outputs' depth for each probe and scatter of a live entry."""
    live = [int(r.n) for r in regs]
    nbytes = sum(n * entry_bytes(r) + 4 for n, r in zip(live, regs)) \
        + 2 * cc * entry_bytes(regs[0]) + 8
    ops = sum(live) * 3 * depth(cc)
    if base is None:
        return nbytes + 4 * live[3], ops
    return (nbytes + search_bytes(base, live[3]) + 4,
            ops + live[3] * depth(max(int(base.n), 2)))


def fold_base_line(label, regs, base, cc, reps, kernel):
    """The base form of the commit fold (one launch, base probed inside)
    against the sequence it replaced on the main path (the merge-rank probe
    of base, the compare, the ``in_ba`` form), both held to the plain
    version first: CUDA-event ms, device ms, ``host_us``, the bound.
    Logs one JSON line ``{"commit_fold_base": {...}}`` and returns it."""
    import torch
    from repro_torch.core import csr
    from repro_torch.kernels.merge import fold as mfold
    ci, cd, ui, ud = regs

    def base_k():
        return mfold.commit_fold(ci, cd, ui, ud, base=base, cins_cap=cc,
                                 cdel_cap=cc)

    def seq():
        lt, le = csr.index_ranks(base, csr._qcols_of(ud), ud.val)
        return mfold.commit_fold(ci, cd, ui, ud, (le > lt).to(torch.int32),
                                 cins_cap=cc, cdel_cap=cc)

    def base_p():
        return mfold._commit_fold_base_ref(ci, cd, ui, ud, base, cc, cc)

    got, want, other = base_k(), base_p(), seq()
    sync()
    err = max(max_abs_err(got, want), max_abs_err(other, want))
    nbytes, ops = fold_work(regs, cc, base)
    b_ms, b_by = bound(nbytes, ops)
    row = dict(label=label, kernel=kernel, max_abs_err=err,
               ms=cuda_ms(base_k, reps), device_ms=device_ms(base_k, reps,
                                                             kernel),
               host_us=host_us(base_k, reps),
               sequence_ms=cuda_ms(seq, reps),
               sequence_device_ms=library_device_ms(
                   seq, reps, "rank + compare + in_ba fold"),
               sequence_host_us=host_us(seq, reps),
               plain_ms=cuda_ms(base_p, max(reps // 10, 2)), bound_ms=b_ms,
               bound_by=b_by, base_n=int(base.n), udel_n=int(ud.n),
               caps=[r.capacity for r in regs] + [cc])
    log("  " + json.dumps({"commit_fold_base": row}))
    return row


def fold_edge_checks(make, base, base_rows: np.ndarray, label: str, cc: int,
                     ub: int, seed: int, timed=None) -> None:
    """The commit fold at its edge inputs, both forms against their plain
    versions bit for bit, at the main path's sizes: committed regions of
    capacity ``cc``, deltas (uins and udel) of ``ub`` and of each
    capacity of FOLD_DELTA_CAPS up to ``cc``, ``base`` itself (its rows
    ``base_rows``).  ``make(rows, cap)`` builds a region of the layout
    under test.  Cases, at each delta capacity: a mixed fold; udel empty;
    n = capacity in every region (base cut to its first power-of-two
    entries); every cins entry deleted; uins inside cins; udel absent
    from base; cins_cap below the union (the writes past it drop); and at
    ``ub`` every region cut to 16 entries (a one-block grid).  Each call's
    grid size (``repro_commit_fold_grid``) goes to FOLD_GRIDS.  ``timed``
    ``(reps, kernel)`` also times the base form of the mixed fold at each
    delta capacity above ``ub`` (``fold_base_line``)."""
    import torch
    from repro_torch.core.csr import IndexData
    from repro_torch.kernels import _build
    from repro_torch.kernels.merge import fold as mfold
    t0 = time.time()
    rng = np.random.default_rng(seed + 37)
    ar = base_rows.shape[1]
    top = int(base_rows.max()) + 1
    caps = sorted({ub} | {u for u in FOLD_DELTA_CAPS if u <= cc})
    um = caps[-1]

    def absent(n):  # distinct rows whose first column no row of base has
        r = rng.integers(0, top, (n, ar)).astype(np.int32)
        r[:, 0] = top + np.arange(n, dtype=np.int32) // 4
        r[:, 1] = np.arange(n, dtype=np.int32) % 4
        return r

    fresh = absent(cc + 2 * um)
    f_ci, f_ui, gone = fresh[:cc], fresh[cc:cc + um], fresh[cc + um:]
    held = base_rows[rng.choice(base_rows.shape[0], cc + um, replace=False)]

    def cut(r, cap):  # the first cap entries of r, a region of their own
        n = torch.tensor(min(int(r.n), cap), dtype=torch.int32,
                         device=r.key.device)
        return IndexData(r.key[:cap], r.val[:cap], n,
                         None if r.lo is None else r.lo[:cap])

    full_base = cut(base, 1 << (int(base.n).bit_length() - 1))

    def cases_at(u):
        """(cins, cdel, uins, udel rows, base, cins_cap) by case, deltas
        of capacity u."""
        ud_mix = np.concatenate([held[:u // 4], held[cc:cc + u // 4],
                                 gone[:u // 4], f_ci[:u // 8]])
        return {
            "mixed": (f_ci[:cc // 2], held[:cc // 3],
                      np.concatenate([f_ui[:u // 2], f_ci[:u // 4]]), ud_mix,
                      base, cc),
            "udel empty": (f_ci[:cc // 2], held[:cc // 3], f_ui[:u],
                           ud_mix[:0], base, cc),
            "n = cap": (f_ci, held[:cc], f_ui[:u],
                        np.concatenate([held[:u // 2], f_ci[:u // 2]]),
                        full_base, cc),
            "all cins deleted": (f_ci[:u - 48], held[:cc // 3],
                                 f_ui[:u // 2],
                                 np.concatenate([f_ci[:u - 48],
                                                 held[cc:cc + 48]]), base,
                                 cc),
            "uins in cins": (f_ci[:cc // 2], held[:cc // 3],
                             f_ci[:min(u, cc // 2)], ud_mix, base, cc),
            "udel not in base": (f_ci[:cc // 2], held[:cc // 3], f_ui[:u],
                                 gone[:u // 2], base, cc),
            "overflow": (f_ci[:cc // 2], held[:cc // 3], f_ui[:u], ud_mix,
                         base, cc // 4),
        }

    lib = _build.lib("fold")
    out = {}

    def check(what, regs, b, cap_i, cap_d):
        ci, cd, ui, ud = regs
        in_ba = mfold.base_bits(b, ud)
        for form, kw in (("in_ba", dict(in_ba=in_ba)), ("base", dict(base=b))):
            got = mfold.commit_fold(ci, cd, ui, ud, cins_cap=cap_i,
                                    cdel_cap=cap_d, **kw)
            want = mfold._commit_fold_ref(ci, cd, ui, ud, in_ba, cap_i, cap_d)
            sync()
            max_abs_err(got, want)
            rr = (ci, cd, ui, ud) + ((b,) if form == "base" else ())
            g = lib.repro_commit_fold_grid(_build.region_desc(rr), len(rr),
                                           int(ci.lo is not None), cap_i,
                                           cap_d)
            if g < 1:
                raise AssertionError(f"{label} {what}: grid query failed "
                                     f"({g})")
            FOLD_GRIDS.setdefault(g, []).append(f"{label} {what} {form}")
        out[what] = [int(want[0].n), int(want[1].n), int(in_ba.sum())]

    for u in caps:
        for what, (r_ci, r_cd, r_ui, r_ud, b, cap_i) in cases_at(u).items():
            regs = (make(r_ci, cc), make(r_cd, cc), make(r_ui, u),
                    make(r_ud, u))
            if what == "n = cap" and not all(int(r.n) == r.capacity
                                             for r in regs + (b,)):
                raise AssertionError(f"{label}: n = cap case has n "
                                     f"{[int(r.n) for r in regs + (b,)]}")
            check(f"{what} (deltas {u})", regs, b, cap_i, cc)
            if what == "mixed" and u == ub:
                check("16 entries", tuple(cut(r, 16) for r in regs), base,
                      16, 20)
            if what == "mixed" and u != ub and timed is not None:
                fold_base_line(f"{label} deltas {u}", regs, base, cc,
                               *timed)
    log(f"  commit fold edge cases {label}: base n={int(base.n)}, caps "
        f"{cc}/{caps}: both forms exact in {time.time() - t0:.2f} s; (n of "
        f"cins', n of cdel', udel in base) {out}")


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

        # -- commit fold (projection or live set): the in_ba form ---------
        ci, cd, ui, ud = regs[1], negs[0], regs[2], negs[1]
        in_ba = mfold.base_bits(base, ud)

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
        nbytes, ops = fold_work((ci, cd, ui, ud), cc)
        record("commit_fold", err, ms, dms, pms, nbytes, ops, None,
               f"{label} caps={ci.capacity}/{cd.capacity}/{ui.capacity}/"
               f"{ud.capacity} out={cc}", main=narrow, host=hus)
        # the base form (the main path's), and the fold's edge inputs
        fold_base_line(label, (ci, cd, ui, ud), base, cc, reps,
                       "commit_fold")
        fold_edge_checks((lambda r, c: proj(r, True, c)) if narrow
                         else (lambda r, c: packed(r, c)), base, edges,
                         label if narrow else "i64 packed", cc,
                         update_batch, seed,
                         timed=(reps, "commit_fold") if narrow else None)

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
            fold_edge_checks(lambda r, c: proj(r, False, c), wide[0], edges,
                             "i64 projection", cc, update_batch, seed)
        edge = member_edge_checks(pos[0][0], edges, narrow, label, seed)
        extend_rank_edge_checks(pos[0][0], edges, edge, label, seed)
        del edge
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

        # -- commit fold of the live set: the in_ba form
        in_ba = mfold.base_bits(base, ud)

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
        nbytes, ops = fold_work((ci, cd, ui, ud), cc)
        record("commit_fold_lex", err, ms, dms, pms, nbytes, ops, None,
               f"{label} caps={ci.capacity}/{cd.capacity}/{ui.capacity}/"
               f"{ud.capacity} out={cc}", main=main, host=hus)
        if label != "quad i64":  # the base form, and the edge inputs
            fold_base_line(label, (ci, cd, ui, ud), base, cc, reps,
                           "commit_fold_lex")
            fold_edge_checks(lambda r, c: live(r, narrow, c), base, rows,
                             label, cc, update_batch, seed,
                             timed=(reps, "commit_fold_lex") if main
                             else None)

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
        edge = member_edge_checks(q_pos[0], quad, narrow,
                                  f"composite {label}", seed)
        extend_rank_edge_checks(q_pos[0], quad, edge, f"composite {label}",
                                seed)
        del edge
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
    before = compaction_counts(session)
    live, secs = run_stream(session, stream, edges, epochs,
                            f"serve {edges.shape[0]} edges")
    counts = kernels.launches()
    n_live = session.num_edges
    if n_live != live.shape[0]:
        raise AssertionError(f"serve: live edges {n_live} != host-tracked "
                             f"{live.shape[0]}")
    require_launches("serve", counts, expected_kernels(handles, ()))
    require_rank_launches("serve", counts, session, before)
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
        composite_compactions=session.stats.composite_compactions,
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
SESSION_KERNELS = ("signed_member", "fused_extend", "commit_fold")
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


def compaction_counts(session) -> tuple:
    """Compactions the session has run (of a relation's live set or of a
    stored projection, each one ``delta._compact_fold``): of 1-word
    regions, and of composite (hi, lo) ones."""
    st = session.stats
    return (st.compactions + st.live_compactions - st.composite_compactions,
            st.composite_compactions)


def require_rank_launches(label, counts, session, before: tuple) -> None:
    """Since the commit fold probes base itself, merge ranks run only in
    ``delta._compact_fold``: in every compaction, three launches each (the
    select's and the merge's two), and where a relation's live rows are
    read back to the host.  Each layout on its own: the run's
    ``rank_lt_le`` launches must be at least three a compaction of a
    1-word region, its ``rank_lt_le_lex`` three a composite one."""
    n = [a - b for a, b in zip(compaction_counts(session), before)]
    for name, k in zip(("rank_lt_le", "rank_lt_le_lex"), n):
        if counts[name] < 3 * k:
            raise AssertionError(f"{label}: {counts[name]} {name} launches "
                                 f"for {k} compactions of that layout "
                                 f"({counts})")


def expected_kernels(handles, rels):
    """The launch names a session path must show: the 1-word membership,
    fused-extend and commit-fold kernels of the streaming engine; with an
    n-ary relation its composite normalize and commit fold; and the
    composite fused extend where a delta plan binds 3-4 columns.  Merge
    ranks run in compactions only (``require_rank_launches``)."""
    names = list(SESSION_KERNELS)
    if rels:
        names += ["signed_member_lex", "commit_fold_lex"]
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
    before = compaction_counts(session)
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
    require_rank_launches("verify", counts, session, before)
    return counts


def cell_spec(scale, queries, epochs, batch) -> str:
    """The ``SCALE:query,query[@EPOCHS[/BATCH]]`` text of a cell."""
    spec = f"{scale}:{','.join(queries)}"
    if epochs or batch:
        spec += f"@{epochs or ''}" + (f"/{batch}" if batch else "")
    return spec


VERIFY_LAUNCHES = "verify launches: "


def verify_only(checks, update_batch: int, seed: int) -> int:
    """``--verify-only``: the verify cells in this process, then their
    launch counts summed, as one JSON line."""
    from repro_torch.kernels import VARIANTS
    total = {name: 0 for name in VARIANTS}
    for scale, queries, epochs, batch in checks:
        with phase(f"verify {cell_spec(scale, queries, epochs, batch)}"):
            counts = verify_phase(scale, queries, epochs or 8,
                                  batch or update_batch, seed)
        for name in VARIANTS:
            total[name] += counts[name]
    log(VERIFY_LAUNCHES + json.dumps(total))
    return 0


def verify_cells(checks, update_batch: int, seed: int,
                 meanwhile=None) -> dict:
    """Every verify cell in a process of its own (``--verify-only``), all
    started together: the cells are independent and bound by the host's
    numpy oracle, so they overlap on the host's cores, and ``meanwhile()``
    runs in this process while they do.  Each must exit 0 and print its
    launch counts; returns them summed."""
    from concurrent.futures import ThreadPoolExecutor
    procs = [(cell_spec(*c), subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--verify-only",
         "--verify", cell_spec(*c), "--update-batch", str(update_batch),
         "--seed", str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for c in checks]
    try:
        if meanwhile is not None:
            meanwhile()
        with ThreadPoolExecutor(len(procs)) as ex:
            outs = list(ex.map(lambda sp: sp[1].communicate(timeout=900),
                               procs))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    total, bad = {}, []
    for (spec, p), (out, err) in zip(procs, outs):
        counts = None
        for ln in out.splitlines():
            if ln.startswith(VERIFY_LAUNCHES):
                counts = json.loads(ln[len(VERIFY_LAUNCHES):])
            else:
                log(ln)
        if p.returncode != 0 or counts is None:
            bad.append(spec)
            log(f"  verify {spec}: rc {p.returncode}; stderr: "
                f"{err[-2000:]}")
            continue
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    if bad:
        raise AssertionError(f"verify cells failed: {bad}")
    return total


def start_coverage():
    """``python -m repro_torch.launch.kernel_coverage`` on the card, a
    process of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return time.time(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.kernel_coverage"],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish_coverage(started) -> dict:
    """The coverage gate's record: it must exit 0 with ``ok``, zero warm
    compiles, the composite ``tri`` relation, one commit-fold launch per
    relation and at least one probe launch."""
    t0, p = started
    try:
        out, err = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1]) if lines else {}
    cov = rec.get("coverage", {})
    log(f"  kernel coverage: rc {p.returncode}, collected after "
        f"{time.time() - t0:.2f} s (with the verify cells), "
        f"warm compiles {rec.get('warm_compiles')}, launches (fold, probe) "
        f"{ {r: (c['fold_pallas_calls'], c['probe_pallas_calls']) for r, c in cov.items()} }, "
        f"{err.strip().splitlines()[-1] if err.strip() else ''}")
    if p.returncode != 0 or not rec.get("ok") or rec["warm_compiles"] \
            or "tri" not in rec["composite_relations"] \
            or any(c["fold_pallas_calls"] != 1 or c["probe_pallas_calls"] < 1
                   for c in cov.values()):
        raise AssertionError(f"kernel coverage failed: {rec or err[-2000:]}")
    return rec


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
    before = compaction_counts(session)
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
    require_rank_launches("serve", counts, session, before)
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
        composite_compactions=session.stats.composite_compactions,
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
# phase 6: transactions (snapshot, restore, faults), §5.4, the public folds
# ---------------------------------------------------------------------------

TXN_EPOCHS = 4  # epochs on session A before its snapshot
TXN_LOCKSTEP = 4  # then epochs 4-7 on A and the restored B in lockstep
TXN_B_EDGES = 1024  # B is built over these first edges only
TXN_NARY_SCALE = 12  # the composite session's R-MAT scale
TXN_NARY_EPOCHS = (2, 2)  # its epochs before / after the restore
OPT_SCALES = (11, 12)  # §5.4: against the host oracle / a card count
TXN_FAULTS = ("store.commit.fold@2", "store.normalize@1")
OPT_CFG = dict(batch=8192, seed_chunk=8192)  # §5.4 on the card
FOLD_SAMPLE = 65_536  # rows of the public folds' second region


def snapshot_leaves_equal(a, b, label: str) -> None:
    """Two snapshots' leaves equal: names, dtypes, shapes and bits."""
    (la, ma), (lb, mb) = a, b
    if ma["names"] != mb["names"] or len(la) != len(lb):
        raise AssertionError(f"{label}: snapshot leaf names differ")
    for name, x, y in zip(ma["names"], la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            raise AssertionError(f"{label}: snapshot leaf {name} differs")


def snapshots_equal(a, b, label: str) -> None:
    """Leaf for leaf, and the metas equal outside ``stats`` once through
    JSON (as a checkpoint stores them)."""
    snapshot_leaves_equal(a, b, label)
    ma, mb = (json.loads(json.dumps(m)) for m in (a[1], b[1]))
    ma.pop("stats")
    mb.pop("stats")
    if ma != mb:
        raise AssertionError(f"{label}: snapshot metas differ: "
                             f"{sorted(k for k in ma if ma[k] != mb.get(k))}")


def deltas_equal(ra, rb, label: str) -> None:
    """Two epoch results bit for bit: every relation's normalized batch,
    and every query's tuples, weights and count delta."""
    if set(ra.deltas) != set(rb.deltas) or set(ra.by_rel) != set(rb.by_rel):
        raise AssertionError(f"{label}: different queries or relations")
    for rel, pair in ra.by_rel.items():
        for x, y in zip(pair, rb.by_rel[rel]):
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: {rel} batch differs")
    for name, a in ra.deltas.items():
        b = rb.deltas[name]
        same = a.count_delta == b.count_delta and \
            (a.tuples is None) == (b.tuples is None) and \
            (a.tuples is None or (np.array_equal(a.tuples, b.tuples)
                                  and np.array_equal(a.weights, b.weights)))
        if not same:
            raise AssertionError(f"{label}: {name} delta differs")


def region_devices(session) -> set:
    """Device types of every tensor of a session's store."""
    store = session.store
    idxs = [i for st in store._rels.values()
            for i in (st.lb, st.lc_ins, st.lc_del)]
    idxs += [getattr(r, "d_" + n) for r in store.projections.values()
             if not r.derived
             for n in ("base", "cins", "cdel", "uins", "udel")]
    return {t.device.type for i in idxs
            for t in (i.key, i.val, i.n, i.lo) if t is not None}


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def counted(total: dict, fn):
    """``fn()`` with the kernel counts set to 0 before and added to
    ``total`` after."""
    from repro_torch import kernels
    kernels.reset_launches()
    out = fn()
    add_counts(total, kernels.launches())
    return out


def timed(fn):
    sync()
    t = time.time()
    out = fn()
    sync()
    return out, time.time() - t


def txn_restore(session, new_session, label: str):
    """Snapshot ``session``, save it with the port's checkpoint under
    ``build/`` (gitignored), read it back with ``restore_latest_raw`` and
    restore it into ``new_session()``; returns the restored session and
    each step's seconds."""
    from repro_torch.checkpoint import CheckpointManager
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"txn_{label}")
    (leaves, meta), t_snap = timed(session.snapshot)
    mgr = CheckpointManager(root, keep_last=1)
    _, t_save = timed(lambda: mgr.save(leaves, session.epoch, extra=meta))
    (got, manifest), t_load = timed(mgr.restore_latest_raw)
    b = new_session()
    _, t_restore = timed(lambda: b.restore(got, manifest["extra"]))
    if region_devices(b) != {DEVICE}:
        raise AssertionError(f"{label}: restored regions on "
                             f"{region_devices(b)}, not all on the card")
    if b.epoch != session.epoch:
        raise AssertionError(f"{label}: restored epoch {b.epoch}")
    out = dict(leaves=len(leaves),
               leaf_bytes=int(sum(x.nbytes for x in leaves)),
               snapshot_s=t_snap, save_s=t_save, load_s=t_load,
               restore_s=t_restore)
    log(f"  txn {label}: " + json.dumps(out))
    return b, out


def txn_edge(edges, nv, update_batch, ratio, seed, total):
    """Steps 1-3 at the serve 20:triangle cell's size."""
    from repro_torch import faults
    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.errors import FaultInjected

    def session(rows):
        s = GraphSession(rows, device=DEVICE, update_batch=update_batch,
                         compact_ratio=ratio)
        s.register("triangle")
        return s

    a, t_build = timed(lambda: session(edges))
    stream = EdgeUpdateStream(nv, update_batch, seed=seed + 3)
    live = edges
    for epoch in range(TXN_EPOCHS):
        upd, w = stream.batch_at(epoch, live)
        res = counted(total, lambda: a.update(upd, w))
        live = res.advance(live)
    b, out = txn_restore(a, lambda: session(edges[:TXN_B_EDGES]), "edge")
    out["build_a_s"] = t_build
    b_counts, a_secs, b_secs = {}, [], []
    for epoch in range(TXN_EPOCHS, TXN_EPOCHS + TXN_LOCKSTEP):
        upd, w = stream.batch_at(epoch, live)
        ra, ta = timed(lambda: counted(total, lambda: a.update(upd, w)))
        rb, tb = timed(lambda: counted(b_counts, lambda: b.update(upd, w)))
        deltas_equal(ra, rb, f"txn edge epoch {epoch}")
        a_secs.append(ta)
        b_secs.append(tb)
        rows = 0 if ra.deltas["triangle"].tuples is None \
            else ra.deltas["triangle"].tuples.shape[0]
        log(f"  txn edge epoch {epoch}: A {ta * 1e3:.1f} ms, B "
            f"{tb * 1e3:.1f} ms, {rows} delta rows equal")
        live = ra.advance(live)
    require_launches("txn B", b_counts, SESSION_KERNELS)
    add_counts(total, b_counts)
    snapshots_equal(a.snapshot(), b.snapshot(), "txn edge lockstep")
    out.update(b_launches=b_counts, b_first_epoch_ms=b_secs[0] * 1e3,
               a_p50_ms=float(np.percentile(np.asarray(a_secs) * 1e3, 50)),
               b_p50_ms=float(np.percentile(np.asarray(b_secs) * 1e3, 50)))
    # step 3: a fault at a projection fold (hit 2: the live set's fold is
    # staged) and one at normalize; A rolls back, the retry equals B's
    for k, spec in enumerate(TXN_FAULTS):
        epoch = TXN_EPOCHS + TXN_LOCKSTEP + k
        upd, w = stream.batch_at(epoch, live)
        pre, e0 = a.snapshot(), a.epoch
        faults.install(spec)
        try:
            a.update(upd, w)
            raise AssertionError(f"txn: {spec} did not fault")
        except FaultInjected as exc:
            log(f"  txn fault {spec}: {exc}")
        finally:
            faults.clear()
        if a.epoch != e0:
            raise AssertionError(f"txn: {spec} moved the epoch")
        snapshot_leaves_equal(pre, a.snapshot(), f"txn after {spec}")
        ra = counted(total, lambda: a.update(upd, w))
        rb = counted(total, lambda: b.update(upd, w))
        deltas_equal(ra, rb, f"txn retry after {spec}")
        log(f"  txn fault {spec}: store equal to its pre-epoch snapshot; "
            f"the retry equals B's delta")
        live = ra.advance(live)
    out["faults"] = list(TXN_FAULTS)
    log("  txn edge: " + json.dumps(out))
    return out


def txn_nary(seed, update_batch, total):
    """Step 4: steps 1-2 on a composite session (R-MAT scale 12,
    triangle,4-clique-tri, ``tri`` fed the triangle deltas)."""
    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph
    edges = rmat_graph(TXN_NARY_SCALE, 16, seed=seed)
    ratio = 8 * update_batch / edges.shape[0]
    names = ["triangle", "4-clique-tri"]
    a, _, rels, _, _ = open_nary_session(edges, names, update_batch, ratio)
    # the static 4-clique-tri plan's projections, one of them derived from
    # tri's live rows (ensured, not run: 14.6M cliques to count at scale 12)
    a._static_plan(a["4-clique-tri"].query)
    stream = EdgeUpdateStream(1 << TXN_NARY_SCALE, update_batch,
                              seed=seed + 4)
    live = edges
    before, after = TXN_NARY_EPOCHS
    for epoch in range(before):
        upd, w = stream.batch_at(epoch, live)
        r1, _, _, _ = counted(total, lambda: nary_epoch(a, rels, upd, w))
        live = r1.advance(live)
    b, out = txn_restore(
        a, lambda: GraphSession(edges[:TXN_B_EDGES], device=DEVICE,
                                update_batch=update_batch,
                                compact_ratio=ratio), "nary")
    leaves, meta = a.snapshot()
    if not any(n.endswith(".lo") for n in meta["names"]) or \
            not any(p["derived"] for p in meta["projections"]):
        raise AssertionError("txn nary: no lo leaves or derived projection")
    b_counts = {}
    for epoch in range(before, before + after):
        upd, w = stream.batch_at(epoch, live)
        ra1, ra2, _, _ = counted(total, lambda: nary_epoch(a, rels, upd, w))
        rb1, rb2, _, _ = counted(b_counts,
                                 lambda: nary_epoch(b, rels, upd, w))
        deltas_equal(ra1, rb1, f"txn nary edge epoch {epoch}")
        deltas_equal(ra2, rb2, f"txn nary tri epoch {epoch}")
        live = ra1.advance(live)
    require_launches("txn nary B", b_counts,
                     expected_kernels(b.handles, rels))
    add_counts(total, b_counts)
    snapshots_equal(a.snapshot(), b.snapshot(), "txn nary lockstep")
    out.update(b_launches=b_counts,
               derived=sum(p["derived"] for p in meta["projections"]))
    log(f"  txn nary: lockstep equal; {json.dumps(out)}")
    return out


def opt_phase(seed, total):
    """Step 5: the §5.4 transformations on the card."""
    from repro_torch import kernels
    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import (BigJoinConfig, build_indices,
                                          run_bigjoin, seed_tuples_for)
    from repro_torch.core.csr import Graph
    from repro_torch.core.delta import _unique_rows
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.optimizations import (build_triangle_relation,
                                                four_clique_via_tri,
                                                symmetry_break)
    from repro_torch.core.plan import make_plan
    from repro_torch.data.synthetic import rmat_graph

    out = {}
    host, card = OPT_SCALES
    g_host = symmetry_break(Graph.from_edges(rmat_graph(host, 16, seed=seed)))
    rels = {Q.EDGE: g_host.edges}
    tri, t_tri = timed(lambda: counted(total, lambda: build_triangle_relation(
        g_host, "bigjoin", device=DEVICE)))
    ref, t_ref = timed(lambda: build_triangle_relation(g_host, "oracle"))
    if not np.array_equal(_unique_rows(tri), _unique_rows(ref)):
        raise AssertionError("§5.4: the card's tri rows differ from the "
                             "host oracle's")
    cfg = BigJoinConfig(out_capacity=1 << 23, **OPT_CFG)
    (c4, _), t_c4 = timed(lambda: counted(total, lambda: four_clique_via_tri(
        g_host, "bigjoin", cfg=cfg, device=DEVICE)))
    flat, t_flat = timed(lambda: generic_join(
        Q.four_clique(symmetric=True), rels, enumerate_results=False)[1])
    if c4 != flat:
        raise AssertionError(f"§5.4 scale {host}: 4-cliques via tri {c4} "
                             f"!= generic_join {flat}")
    out[host] = dict(edges=int(g_host.edges.shape[0]), tri=int(tri.shape[0]),
                   four_cliques=int(c4), tri_s=t_tri, oracle_tri_s=t_ref,
                   via_tri_s=t_c4, host_flat_s=t_flat)
    log(f"  §5.4 scale {host}: " + json.dumps(out[host]))
    g_card = symmetry_break(Graph.from_edges(rmat_graph(card, 16, seed=seed)))
    kernels.reset_launches()
    cfg = BigJoinConfig(out_capacity=1 << 26, **OPT_CFG)
    (c4, _), t_c4 = timed(lambda: four_clique_via_tri(g_card, "bigjoin",
                                                      cfg=cfg,
                                                      device=DEVICE))
    via = kernels.launches()
    add_counts(total, via)
    q = Q.four_clique(symmetric=True)
    plan = make_plan(q)
    rels = {Q.EDGE: g_card.edges}

    def flat_count():
        idx = build_indices(plan, rels, device=DEVICE)
        return run_bigjoin(plan, idx, seed_tuples_for(plan, rels),
                           cfg=BigJoinConfig(mode="count", **OPT_CFG)).count
    flat, t_flat = timed(lambda: counted(total, flat_count))
    out[card] = dict(edges=int(g_card.edges.shape[0]), four_cliques=int(c4),
                     flat=int(flat), via_tri_s=t_c4, flat_s=t_flat,
                     via_launches={k: v for k, v in via.items() if v})
    log(f"  §5.4 scale {card}: " + json.dumps(out[card]))
    if c4 != flat:
        raise AssertionError(f"§5.4 scale {card}: 4-cliques via tri {c4} "
                             f"!= the static count {flat}")
    return out


def public_folds_phase(edges, tri, seed):
    """Step 6: ``merge_index``, ``diff_index`` and ``intersect_index`` on
    the card (the rank kernels) against the same calls on CPU copies (the
    plain searches), bit for bit with the padding, over the scale-18
    edge set (the scale-20 one until the mesh stream) and the scale-14
    ``tri`` rows (composite) with a region of
    65,536 rows, half of them in the relation: the whole relation merged
    with the small region (as a compaction merges), the small region
    less and within the relation (as a commit probes), each at a
    capacity that holds the result and at half of it, below the union.
    The CPU copies' plain searches take most of the step's time."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import csr
    from repro_torch.core.delta import _packed_index

    rng = np.random.default_rng(seed + 5)
    dev = torch.device(DEVICE)
    out = {}
    for label, rows, arity in (("edge", edges, 2), ("tri", tri, 3)):
        nv = int(rows.max()) + 1
        other = np.concatenate([
            rows[rng.integers(0, rows.shape[0], FOLD_SAMPLE // 2)],
            rng.integers(0, nv, (FOLD_SAMPLE // 2, arity)).astype(np.int32)])
        a = _packed_index(rows, dev, arity)
        b = _packed_index(other, dev, arity)
        ha = csr.IndexData(*(None if t is None else t.cpu()
                             for t in (a.key, a.val, a.n, a.lo)))
        hb = csr.IndexData(*(None if t is None else t.cpu()
                             for t in (b.key, b.val, b.n, b.lo)))
        for fold, (x, y), (hx, hy) in (
                ("merge_index", (a, b), (ha, hb)),
                ("diff_index", (b, a), (hb, ha)),
                ("intersect_index", (b, a), (hb, ha))):
            fn = getattr(csr, fold)
            full = csr.round_capacity(x.capacity + y.capacity)
            n_full = None
            for cap in (full, None):
                cap = cap or csr.round_capacity(max(n_full // 2, 1))
                kernels.reset_launches()
                got, t_card = timed(lambda: fn(x, y, cap))
                counts = kernels.launches()
                want = fn(hx, hy, cap)
                for u, v in ((got.key, want.key), (got.val, want.val),
                             (got.lo, want.lo)):
                    if (u is None) != (v is None) or (
                            u is not None and not torch.equal(u.cpu(), v)):
                        raise AssertionError(f"folds: {label} {fold} at "
                                             f"capacity {cap} differs")
                if int(got.n) != int(want.n):
                    raise AssertionError(f"folds: {label} {fold} count")
                rank = "rank_lt_le_lex" if arity > 2 else "rank_lt_le"
                if counts[rank] == 0:
                    raise AssertionError(f"folds: {label} {fold} launched "
                                         f"no {rank}")
                n_full = n_full or int(got.n)
                out[f"{label} {fold} {cap}"] = dict(
                    n=int(got.n), card_s=t_card, **{rank: counts[rank]})
        log(f"  folds {label}: |a|={int(a.n)} |b|={int(b.n)} bit-exact "
            f"against the CPU copies")
    log("  folds: " + json.dumps(out))
    return out


def txn_phase(edges, nv, update_batch, seed, built, fold_edges=None):
    """Transactions on the card: restore and lockstep, faults, the
    composite form, §5.4 and the public folds.  Returns the kernel counts
    of the sessions and BiGJoin runs (the folds' checks excluded)."""
    total = {}
    ratio = 8 * update_batch / edges.shape[0]
    steps = (("edge", lambda: txn_edge(edges, nv, update_batch, ratio,
                                       seed, total)),
             ("nary", lambda: txn_nary(seed, update_batch, total)),
             ("§5.4", lambda: opt_phase(seed, total)),
             ("folds", lambda: public_folds_phase(
                 edges if fold_edges is None else fold_edges,
                 built["tri"][1], seed)))
    for label, fn in steps:
        _, secs = timed(fn)
        log(f"  txn step {label}: {secs:.2f} s")
    log(f"  txn launches: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# phase 7: the serving pool — four tenants on one card, WAL and snapshots
# ---------------------------------------------------------------------------

POOL_SCALE = 18  # four tenants hold the serve 20:triangle cell's edges
POOL_TENANTS = 4
POOL_EPOCHS = 6  # timed pipelined steps (8 before the dry run phase)
POOL_IDLE_STEPS = 3  # then a profiled window of about 2 s
POOL_SNAPSHOT_EVERY = 4
POOL_BURST = (8, 256)  # the coalescing tenant: 8 clean batches of 256
POOL_RECOVER = "t0"  # 9 epochs: snapshot at 8, epoch 9 replayed
# the subprocesses, each in a process of its own, all started together:
# (label, module, arguments, what its output must show)
POOL_CHILDREN = (
    ("serve_check supervise", "repro_torch.serve._serve_check",
     ["--supervise", "--tenants", "4", "--nv", "65536", "--ne", "1048576",
      "--batch-size", "2048", "--update-batch", "2048", "--epochs", "8",
      "--kill-at", "5"], '"all_exact": true'),
    ("serve_check chaos", "repro_torch.serve._serve_check",
     ["--chaos", "--tenants", "4", "--nv", "16384", "--ne", "262144",
      "--batch-size", "512", "--update-batch", "512", "--epochs", "30",
      "--tight-out", "32"], '"oracle_exact": true'),
    ("serve stream", "repro_torch.launch.serve",
     ["--stream", "--query", "triangle,diamond", "--scale", "12",
      "--epochs", "2", "--verify"], "✓"),
    ("serve concurrent", "repro_torch.launch.serve",
     ["--concurrent", "2", "--query", "triangle", "--scale", "12",
      "--epochs", "4", "--verify"], "✓"),
    # the stream across 2 gloo ranks, every rank on the card, durable
    ("serve stream ranks", "torch.distributed.run",
     ["--standalone", "--nproc-per-node", "2", "-m",
      "repro_torch.launch.serve", "--stream", "--workers", "4", "--backend",
      "gloo", "--query", "triangle", "--scale", "12", "--epochs", "3",
      "--verify", "--durable-dir", os.path.join("build", "pool_ranks"),
      "--snapshot-every", "2"], "verified triangle"),
    ("serve gemma2-2b", "repro_torch.launch.serve",
     ["--arch", "gemma2-2b", "--steps", "8"], "decode:"),
    ("run_query delta", "repro_torch.launch.run_query",
     ["--mode", "delta", "--scale", "12", "--verify"], "recompute diff ✓"),
)
SESSION_OPS = ("repro_torch.kernels.intersect.ops",
               "repro_torch.kernels.extend.ops",
               "repro_torch.kernels.merge.fold",
               "repro_torch.kernels.merge.ops")


def launch_threads():
    """Wrap the session kernels' launch counters so each launch also
    records its thread's name; returns (counts by (kernel, thread),
    undo)."""
    import importlib
    import threading
    by_thread, undo = {}, []
    for name in SESSION_OPS:
        mod = importlib.import_module(name)
        inner = mod.count_launch

        def count(kernel, inner=inner):
            inner(kernel)
            key = (kernel, threading.current_thread().name)
            by_thread[key] = by_thread.get(key, 0) + 1
        mod.count_launch = count
        undo.append((mod, inner))

    def restore():
        for mod, inner in undo:
            mod.count_launch = inner
    return by_thread, restore


def require_apply_thread(by_thread: dict) -> None:
    threads = sorted({t for (_k, t) in by_thread})
    if threads != ["pool-apply"]:
        raise AssertionError(f"pool: session kernels launched from "
                             f"{threads}, not the apply thread alone")


def start_children(root: str, children=POOL_CHILDREN, **env_vars) -> dict:
    """Start ``python -m module args`` for every child, each in a session
    of its own, so that :func:`finish_children` ends the processes a
    child starts (``torch.distributed.run``'s ranks) with it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), **env_vars)
    return {label: (time.time(), subprocess.Popen(
        [sys.executable, "-m", module] + args, env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True))
        for label, module, args, _ in children}


def finish_children(procs: dict, children=POOL_CHILDREN,
                    what: str = "pool", outs=None) -> dict:
    """Wait for every child; each must exit 0 and print what its entry of
    ``children`` names.  Returns each child's seconds; ``outs``, when
    given, receives each child's standard output."""
    from concurrent.futures import ThreadPoolExecutor
    want = {label: mark for label, _m, _a, mark in children}

    def wait(t0, p):  # each child's output and its own seconds
        out, err = p.communicate(timeout=600)
        return out, err, time.time() - t0

    secs, bad = {}, []
    try:
        with ThreadPoolExecutor(len(procs)) as ex:
            futs = {label: ex.submit(wait, t0, p)
                    for label, (t0, p) in procs.items()}
        for label, (_t0, p) in procs.items():
            out, err, secs[label] = futs[label].result()
            if outs is not None:
                outs[label] = out
            lines = out.strip().splitlines()
            shown = [ln for ln in lines if want[label] in ln]
            log(f"  {what} child {label}: rc {p.returncode}, "
                f"{secs[label]:.2f} s")
            for ln in (shown or lines)[-2:]:
                log(f"    {ln[:600]}")
            if p.returncode != 0 or not shown:
                bad.append(label)
                log(f"    stderr: {err[-2000:]}")
    finally:
        for _, p in procs.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if bad:
        raise AssertionError(f"{what} children failed: {bad}")
    return secs


def pool_phase(update_batch: int, seed: int) -> dict:
    """Four tenants on one ``SessionPool(device="cuda")``, WAL fsynced and
    a snapshot every 4 epochs under ``build/pool``: t0-t2 dirty
    ``EdgeUpdateStream`` batches at coalesce 1, t3 bursts of clean batches
    at coalesce 8; every epoch's deltas against an isolated session fed
    the batches the tenant's WAL logged; t0 recovered from its directory;
    the serve-check harness and the launch drivers in processes of their
    own.  Returns the kernel counts of the pool's serving."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch import kernels
    from repro_torch.api import GraphSession
    from repro_torch.core.delta import canon_arrays
    from repro_torch.data.synthetic import (EdgeUpdateStream,
                                            clean_update_batches, rmat_graph)
    from repro_torch.serve import SessionPool, WriteAheadLog

    root = os.path.dirname(os.path.abspath(__file__))
    durable = os.path.join(root, "build", "pool")
    for d in (durable, os.path.join(root, "build", "pool_ranks")):
        shutil.rmtree(d, ignore_errors=True)  # the stream child's too
    names = [f"t{i}" for i in range(POOL_TENANTS)]
    nv = 1 << POOL_SCALE
    per, size = POOL_BURST
    total = (POOL_EPOCHS + POOL_IDLE_STEPS) * per
    t0 = time.time()
    with ThreadPoolExecutor(POOL_TENANTS) as ex:  # numpy frees the GIL
        made = {n: ex.submit(rmat_graph, POOL_SCALE, 16, seed=seed + i)
                for i, n in enumerate(names)}
        graphs = {n: f.result() for n, f in made.items()}
    secs = time.time() - t0
    clean, t_clean = timed(lambda: iter(clean_update_batches(
        graphs["t3"], nv, size, total, seed=seed + 3)))
    streams = {n: EdgeUpdateStream(nv, update_batch, seed=seed + 10 + i)
               for i, n in enumerate(names[:3])}
    log(f"  pool: {POOL_TENANTS} graphs of R-MAT scale {POOL_SCALE}, "
        f"|E| {[int(g.shape[0]) for g in graphs.values()]} in "
        f"{secs:.2f} s; {total} clean batches in {t_clean:.2f} s")

    logged = {n: [] for n in names}  # (epoch, batches) as the WAL holds it

    def on_logged(name, epoch):
        # the apply thread, right after the append: read the record back
        with open(os.path.join(durable, name, "wal.log"), "rb") as f:
            rec = WriteAheadLog._decode(f.read().splitlines()[-1])
        if rec is None or rec[0] != epoch:
            raise AssertionError(f"pool: {name}'s WAL tail is not epoch "
                                 f"{epoch}")
        logged[name].append(rec)

    torch.cuda.reset_peak_memory_stats()
    pool = SessionPool(device=DEVICE, update_batch=update_batch,
                       durable_dir=durable, fsync=True,
                       snapshot_every=POOL_SNAPSHOT_EVERY,
                       on_logged=on_logged)
    handles, per_tenant = {}, {}
    for n in names:
        h, t_admit = timed(lambda: pool.admit(
            n, graphs[n], queries=("triangle",),
            coalesce=per if n == "t3" else 1))
        handles[n] = h
        per_tenant[n] = {}
        update = h.session.update

        def counted_update(*a, _update=update, _total=per_tenant[n], **kw):
            before = kernels.launches()
            try:
                return _update(*a, **kw)
            finally:
                after = kernels.launches()
                add_counts(_total, {k: after[k] - before[k] for k in after})
        h.session.update = counted_update
        log(f"  pool: admitted {n} in {t_admit:.2f} s "
            f"({h.stats.prewarm_compiles} compile events)")
    lives = {n: np.asarray(handles[n].session.edges) for n in names[:3]}
    served = {n: {} for n in names}  # epoch -> EpochResult
    depth = [0]

    def step(k):
        tickets = []
        for n in names[:3]:
            upd, w = streams[n].batch_at(k, live=lives[n])
            tickets.append((n, handles[n].submit(upd, w)))
        for _ in range(per):
            upd, w = next(clean)
            tickets.append(("t3", handles["t3"].submit(upd, w)))
        depth[0] = max([depth[0]] + [h.stats.queue_depth
                                     for h in handles.values()])
        for n, t in tickets:
            res = t.result(timeout=600)
            served[n][res.epoch] = res
            if n != "t3":
                lives[n] = res.advance(lives[n])

    kernels.reset_launches()
    by_thread, restore_counts = launch_threads()
    try:
        sync()
        t0 = time.time()
        for k in range(POOL_EPOCHS):
            step(k)
        sync()
        wall = time.time() - t0
        tstats = {n: h.stats.as_dict() for n, h in handles.items()}
        agg = pool.stats().aggregate()
        rows = 3 * POOL_EPOCHS * update_batch + POOL_EPOCHS * per * size
        wall_p, busy, idle, rec, exp = idle_share(
            lambda: [step(k) for k in range(POOL_EPOCHS,
                                            POOL_EPOCHS + POOL_IDLE_STEPS)])
        pool.drain()
        counts = kernels.launches()
        stats = pool.stats()
    finally:
        restore_counts()
    final = {n: handles[n].session for n in names}
    pool.close()
    require_apply_thread(by_thread)
    for n in names:
        require_launches(f"pool {n}", per_tenant[n], SESSION_KERNELS)
    agg_all = stats.aggregate()
    submitted = sum(t.submitted for t in stats.tenants.values())
    if submitted != agg_all["retired"] or agg_all["failed"]:
        raise AssertionError(f"pool: {submitted} submitted, "
                             f"{agg_all['retired']} retired, "
                             f"{agg_all['failed']} failed")
    if stats.serve_compiles != 0:
        raise AssertionError(f"pool: {stats.serve_compiles} serving "
                             f"compile events")

    # t0 closed (the pool is) and re-admitted from its directory, with
    # the card to itself: restore and replay each end with a device wait
    again = SessionPool(device=DEVICE, update_batch=update_batch,
                        durable_dir=durable, fsync=True,
                        snapshot_every=POOL_SNAPSHOT_EVERY)
    h2, t_admit = timed(lambda: again.admit(
        POOL_RECOVER, graphs[POOL_RECOVER], queries=("triangle",),
        coalesce=1))
    dur = again._tenants[POOL_RECOVER].durability
    snapshots_equal(h2.session.snapshot(),
                    final[POOL_RECOVER].snapshot(), "pool recover")
    recover = dict(restore_s=dur.restore_s, replay_s=dur.replay_s,
                   replayed=dur.replayed, admit_s=t_admit,
                   epoch=h2.session.epoch)
    again.close()
    if recover["replayed"] == 0:
        raise AssertionError("pool: the recovery replayed no epoch")
    log(f"  pool recover {POOL_RECOVER}: " + json.dumps(recover))

    # each tenant's WAL, replayed into an isolated session on the card
    # alone, each epoch timed between device waits: the same epochs
    # without the pool's other threads
    t_iso = time.time()
    iso_ms = {}
    for n in names:
        iso = GraphSession(graphs[n], device=DEVICE,
                           update_batch=update_batch)
        iso.register("triangle")
        iso.prewarm()
        epochs = [e for e, _ in logged[n]]
        if epochs != sorted(served[n]) or \
                epochs != list(range(1, len(epochs) + 1)):
            raise AssertionError(f"pool {n}: logged epochs {epochs}")
        iso_ms[n] = []
        for epoch, batches in logged[n]:
            a = served[n][epoch].deltas["triangle"]
            res, secs = timed(lambda: iso.update(batches))
            iso_ms[n].append(1e3 * secs)
            b = res.deltas["triangle"]
            ca = canon_arrays(a.tuples, a.weights, 3) \
                if a.tuples is not None else None
            cb = canon_arrays(b.tuples, b.weights, 3) \
                if b.tuples is not None else None
            same = a.count_delta == b.count_delta and (
                (ca is None and cb is None) or
                (ca is not None and cb is not None and
                 all(np.array_equal(x, y) for x, y in zip(ca, cb))))
            if not same:
                raise AssertionError(f"pool {n}: epoch {epoch} delta "
                                     f"differs from the isolated one")
        if not np.array_equal(iso.edges, final[n].edges) or \
                iso["triangle"].net_change != \
                final[n]["triangle"].net_change:
            raise AssertionError(f"pool {n}: final state differs")
        log(f"  pool {n}: {len(epochs)} epochs equal to the isolated "
            f"session's, net change {iso['triangle'].net_change} "
            f"({time.time() - t_iso:.2f} s)")
        del iso

    # then the processes of their own, all started together
    child_s = finish_children(start_children(root))

    out = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line(),
        tenants=POOL_TENANTS, scale=POOL_SCALE,
        edges={n: int(g.shape[0]) for n, g in graphs.items()},
        steps=POOL_EPOCHS, updates=rows, wall_s=wall,
        updates_per_s=rows / wall,
        apply_ms={n: [d["latency_ms"]["p50"], d["latency_ms"]["p99"]]
                  for n, d in tstats.items()},
        prep_ms_p50={n: d["prep_ms_p50"] for n, d in tstats.items()},
        # the epochs apply_ms covers (the timed steps'), replayed alone:
        # p50 and p99 ms of the update
        isolated_ms={n: [float(np.percentile(v[:POOL_EPOCHS], 50)),
                         float(np.percentile(v[:POOL_EPOCHS], 99))]
                     for n, v in iso_ms.items()},
        epochs={n: d["epochs"] for n, d in tstats.items()},
        max_queue_depth=depth[0],
        coalesced_away=agg["retired"] - agg["epochs"],
        snapshots=agg_all["snapshots"],
        prewarm_compiles=stats.prewarm_compiles,
        serve_compiles=stats.serve_compiles,
        recover=recover,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        profiled_s=wall_p, device_busy_s=busy, idle_share=idle,
        profiled_launches_recorded=[rec, exp],
        launches_by_thread={f"{k}@{t}": v
                            for (k, t), v in sorted(by_thread.items())},
        children_s=child_s)
    log("pool: " + json.dumps(out))
    return counts


# each twin and its arguments: the LM twin trains 40 of its 200 steps
# (34.81 s at 100 and 28.97 s at 60 beside the others: PERF.md §6)
EXAMPLE_TWINS = {"torch_quickstart": (), "torch_incremental_motifs": (),
                 "torch_multi_relation": (),
                 "torch_train_gnn_with_motifs": (),
                 "torch_train_lm": ("--steps", "40")}


def examples_phase() -> None:
    """Every example twin in a process of its own on the card, all at
    once: each must exit 0 and print its "✓" lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {}
    try:
        for name, args in EXAMPLE_TWINS.items():
            procs[name] = (time.time(), subprocess.Popen(
                [sys.executable, os.path.join(root, "examples",
                                              f"{name}.py"), *args],
                env=env, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        bad = []
        for name, (t0, p) in procs.items():
            out, err = p.communicate(timeout=600)
            checks = [ln for ln in out.splitlines() if "✓" in ln]
            log(f"  example {name}: rc {p.returncode}, "
                f"{time.time() - t0:.2f} s, {len(checks)} ✓ lines")
            for ln in checks[-3:]:
                log(f"    {ln}")
            if p.returncode != 0 or not checks:
                bad.append(name)
                log(f"    stderr: {err[-2000:]}")
        if bad:
            raise AssertionError(f"examples failed: {bad}")
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# phases 10-12: GNN training (motif features -> sampler -> GNN with
# segment_sum -> loss -> autograd -> AdamW -> checkpoint)
# ---------------------------------------------------------------------------

# the minibatch_lg shape: the 232,965-node graph of its note at the
# driver's 8 edges per node, 1024 seeds at fanouts 15-10 per step
TRAIN_NODES = 232_965
TRAIN_SEEDS = 1024
TRAIN_FANOUTS = [15, 10]
TRAIN_STEPS = 5  # 1 cold + 4 warm (5 warm before the dry run phase)
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
        record("segment_sum", err, ms, dms, pms, nbytes,
               sops.kernel_ops(E, D), lms,
               f"{label} E={E} D={D} NS={NS} "
               f"{'sorted' if is_sorted else 'unsorted'}"
               f"{'' if kind == 'trainer' else ', ' + kind} rtol={rtol} "
               f"atol={atol}; {sum(per_call.values()) + 1} launches a call",
               main=label == "f32" and is_sorted and kind == "trainer",
               library_device_ms=ldms, host=hus,
               library=f"index_add_ ({dtype})")


def train_driver_phase(seed: int) -> dict:
    """The port's driver (``launch/train.py`` main) with --arch gatedgcn
    and with --arch mixtral-8x7b (its smoke config) at their defaults, each
    to step 10 and relaunched to step 20 in one checkpoint directory: it
    must resume from step 10 and end with a finite loss.  Returns the
    kernel launches of every run."""
    import contextlib
    import io
    import tempfile
    from repro_torch import kernels
    from repro_torch.launch import train
    totals = {}
    for arch in ("gatedgcn", "mixtral-8x7b"):
        runs = []
        kernels.reset_launches()
        with tempfile.TemporaryDirectory() as ck:
            for steps in (10, 20):
                buf = io.StringIO()
                t = time.time()
                with contextlib.redirect_stdout(buf):
                    loss = train.main(["--arch", arch, "--steps",
                                       str(steps), "--seed", str(seed),
                                       "--ckpt-dir", ck])
                runs.append((loss, buf.getvalue()))
                log(f"  train driver {arch} --steps {steps}: "
                    f"{time.time() - t:.2f} s")
                for line in buf.getvalue().splitlines():
                    log(f"    {line}")
        counts = kernels.launches()
        if "resumed from step 10" not in runs[1][1]:
            raise AssertionError(f"train driver {arch}: the relaunch did "
                                 f"not resume from step 10")
        if not np.isfinite(runs[1][0]):
            raise AssertionError(f"train driver {arch}: final loss "
                                 f"{runs[1][0]}")
        if arch == "gatedgcn":
            require_launches("train driver", counts, ["segment_sum",
                                                      "fused_extend"])
        elif counts["flash_attention"]:
            raise AssertionError(f"train driver {arch}: flash launches "
                                 f"{counts['flash_attention']}, expected "
                                 f"none")
        log(f"  train driver {arch}: launches {counts}")
        add_counts(totals, counts)
    return totals


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

    # the first step on the card against the same step on the host; the
    # host's (~25-35 s) runs after the card's timed and profiled steps, so
    # that nothing shares the host with them
    model = G.GNN(cfg, seed=seed)
    kernels.reset_launches()
    card = _loss_and_gnorm(model, batches[0], cfg)
    add(kernels.launches())

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
    t_host = time.time()
    host = G.GNN(cfg, seed=seed, device="cpu")
    cpu = _loss_and_gnorm(host, {k: v.cpu() for k, v in batches[0].items()},
                          cfg)
    log(f"  train full: first step loss / grad norm card {card}, host "
        f"{cpu} (host step {time.time() - t_host:.2f} s)")
    if not (_close(card[0], cpu[0], FULL_STEP_RTOL)
            and _close(card[1], cpu[1], FULL_STEP_RTOL)):
        raise AssertionError(f"train full: the card's first step {card} "
                             f"differs from the host's {cpu}")
    del host
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
# phase 13: the two-tower recsys model (EmbeddingBag through segment_sum)
# ---------------------------------------------------------------------------

RECSYS_STEPS = 5  # full-width training steps, then one profiled
RECSYS_SERVE_CALLS = 50  # serve_p99 calls timed one by one
RECSYS_RETRIEVAL_CALLS = 5
RECSYS_STEP_RTOL = 1e-3  # the smoke step, card against host


def recsys_segment_sum_check(params, cfg, batch: dict, B: int) -> dict:
    """segment_sum against its plain version at the shape the full-width
    forward gives it: each user table's gathered rows of one train batch
    ([B·multi_hot, embed] f32, B sorted bags of multi_hot rows), the
    kernel on the card, the plain version on a host copy of the same
    inputs, at the f32 segment_sum row's tolerance.  Its launches are
    compare launches: the caller resets the counts before it reads them
    again.  Returns the max |err| by table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.segment_ops import ops as sops, ref as sref
    rtol, atol = SEGSUM_TOL["f32"]
    errs = {}
    with torch.no_grad():
        for name, _rows in cfg.user_tables:
            ids = batch["feats"][name]
            M = ids.shape[1]
            flat = F.embedding(ids.reshape(-1).long(),
                               params["tables"][name])
            bag = torch.arange(B, dtype=torch.int32,
                               device=ids.device).repeat_interleave(M)
            got = sops.segment_sum(flat, bag, B, is_sorted=True).cpu()
            want = sref.segment_sum_ref(flat.cpu(), bag.cpu(), B)
            errs[name] = float((got.double() - want.double()).abs().max())
            if got.dtype != torch.float32 or got.shape != want.shape or \
                    not torch.allclose(got, want, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"train recsys: segment_sum of {name} ({tuple(flat.shape)}"
                    f", {B} bags) disagrees with its plain version (max |err|"
                    f" = {errs[name]}, rtol {rtol}, atol {atol})")
            del flat, bag, got, want
    log(f"  train recsys: segment_sum at the forward's shape (E = "
        f"{B * cfg.multi_hot}, D = {cfg.embed_dim}, {B} bags) against its "
        f"plain version on a host copy, rtol {rtol} atol {atol}: max |err| "
        f"{errs}")
    return errs


def train_recsys_phase(seed: int) -> dict:
    """One step of the smoke config on the card against the host (loss
    and gradient norm), then the full-width two-tower model: tables of
    10M, 1M and 100k rows and 1M items, embed 256, towers 1024-512-256,
    f32; RECSYS_STEPS steps at train_batch (65,536 events, 1,024
    negatives): step ms, peak memory, the idle share of a profiled step,
    three segment_sum calls per forward; then serve_p99 (512 events) and
    retrieval_cand (one query against 1,000,000 candidates, top 100)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_family import (SHAPES, event_batch,
                                                   make_train_step)
    from repro_torch.kernels.segment_ops import ops as sops
    from repro_torch.models import recsys as R
    from repro_torch.optim import adamw_init
    spec = get_arch("two-tower-retrieval")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # the smoke step on the card and on the host, from the same parameters
    cfg = spec.smoke_config
    card = R.init(cfg, seed=seed, device=DEVICE)
    host = R.init(cfg, seed=seed, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    got, seg = {}, {}
    for dev, params in ((DEVICE, card), ("cpu", host)):
        kernels.reset_launches()
        m = make_train_step(cfg)(params, adamw_init(params),
                                 event_batch(cfg, 64, 0, dev, seed))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
        counts = kernels.launches()
        seg[dev] = counts["segment_sum"]
        add(counts)
    log(f"  train recsys smoke: loss / grad norm card {got[DEVICE]}, host "
        f"{got['cpu']}, segment_sum launches {seg}")
    if seg[DEVICE] != len(cfg.user_tables) or seg["cpu"] != 0:
        raise AssertionError(f"train recsys: segment_sum launches {seg}")
    if not all(_close(a, b, RECSYS_STEP_RTOL)
               for a, b in zip(got[DEVICE], got["cpu"])):
        raise AssertionError(f"train recsys: the card's smoke step "
                             f"{got[DEVICE]} differs from the host's "
                             f"{got['cpu']}")
    del card, host

    # full width
    cfg = spec.full_config
    B = SHAPES["train_batch"]["batch"]
    E = B * cfg.multi_hot
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.time()
    params = R.init(cfg, seed=seed, device=DEVICE)
    opt = adamw_init(params)
    sync()
    init_s = time.time() - t
    batches = [event_batch(cfg, B, s, DEVICE, seed)
               for s in range(RECSYS_STEPS + 1)]
    step = make_train_step(cfg)
    secs, losses, per_fwd = [], [], []
    for b in batches[:RECSYS_STEPS]:
        kernels.reset_launches()
        sync()
        t = time.time()
        m = step(params, opt, b)
        loss = float(m["loss"])
        sync()
        secs.append(time.time() - t)
        counts = kernels.launches()
        add(counts)
        per_fwd.append(counts["segment_sum"])
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train recsys: {cfg.param_count()} parameters drawn on the card "
        f"in {init_s:.2f} s; step ms {[round(x * 1e3, 3) for x in secs]}, "
        f"losses {losses}, segment_sum calls per forward {per_fwd}, peak "
        f"{peak:.3f} GiB")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"train recsys: losses {losses}")
    if any(n != len(cfg.user_tables) for n in per_fwd):
        raise AssertionError(f"train recsys: segment_sum calls per forward "
                             f"{per_fwd}")
    seg_err = recsys_segment_sum_check(params, cfg, batches[0], B)
    by_name = {}
    wall, busy, idle, rec, exp = idle_share(
        lambda: step(params, opt, batches[-1]), by_name,
        per_call={"segment_sum": sops.kernel_launches(E)})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"  train recsys: profiled step {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {idle} ({rec} of {exp} kernel "
        f"launches recorded); device time by kernel (launches, ms):")
    for name, (n, ms) in top:
        log(f"    {ms:10.3f} ms {n:5d}x {name}")
    del batches
    params.zero_grad(set_to_none=True)

    # serving: the user and item towers of 512 events, one call at a time
    sb = event_batch(cfg, SHAPES["serve_p99"]["batch"], 1000, DEVICE, seed)
    cands = torch.arange(SHAPES["retrieval_cand"]["n_candidates"],
                         dtype=torch.int32, device=DEVICE)
    query = {k: v[:1] for k, v in sb["feats"].items()}
    serve_ms, retr_ms = [], []
    kernels.reset_launches()
    with torch.no_grad():
        for calls, out, fn in (
                (RECSYS_SERVE_CALLS, serve_ms,
                 lambda: R.serve_scores(params, sb["feats"], sb["item_ids"],
                                        cfg)),
                (RECSYS_RETRIEVAL_CALLS, retr_ms,
                 lambda: R.retrieval_topk(params, query, cands, cfg,
                                          k=100))):
            fn()
            for _ in range(calls):
                sync()
                t = time.time()
                r = fn()
                sync()
                out.append((time.time() - t) * 1e3)
        vals, ids = r
    add(kernels.launches())
    if not (bool(torch.isfinite(vals).all()) and vals.shape == (100,)
            and bool((vals[:-1] >= vals[1:]).all())):
        raise AssertionError("train recsys: retrieval top-100 not finite "
                             "and sorted")
    warm = np.asarray(secs[1:]) * 1e3
    out = dict(
        params=cfg.param_count(), train_batch=B, negatives=cfg.num_negatives,
        init_s=init_s, step_ms=[x * 1e3 for x in secs],
        step_p50_ms=float(np.percentile(np.asarray(secs) * 1e3, 50)),
        warm_p50_ms=float(np.percentile(warm, 50)), losses=losses,
        peak_mem_gib=peak, segment_sum_calls_per_forward=per_fwd,
        segment_sum_max_abs_err=seg_err,
        segment_sum_launches_per_forward=len(cfg.user_tables)
        * sops.kernel_launches(E),
        profiled_step_ms=wall * 1e3, device_busy_ms=busy * 1e3,
        idle_share=idle, profiled_launches_recorded=[rec, exp],
        top_kernels_ms={n: ms for n, (_c, ms) in top},
        serve_p99_ms=[float(np.percentile(serve_ms, 50)),
                      float(np.percentile(serve_ms, 99))],
        retrieval_cand_ms=[float(np.percentile(retr_ms, 50)),
                           float(max(retr_ms))],
        launches=totals)
    log("  train recsys: " + json.dumps(out))
    del params, opt
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 9: the mesh (core.distributed, core.balance): w workers as a leading
# tensor axis on the card
# ---------------------------------------------------------------------------

MESH_W = 4
MESH_PARITY_SCALE = 10  # distributed_join on the card against the host
MESH_PARITY_BATCH = 4096  # B' a worker (16,384 for 4-clique-tri)
MESH_QUAD_SCALE = 6  # the composite case, 5-clique-quad over quad
MESH_SCALE = 14  # the serve 14 cell's graph (16 until the mesh stream)
MESH_BATCH = 65_536  # B' a worker at MESH_SCALE
MESH_PROFILED_STEP = 10


def _mesh_cfg(batch: int, mode: str, balance: bool = False):
    """w = MESH_W workers at B' ``batch`` a worker, route capacity 4·B'/w
    (the JAX package's ``default_delta_config`` rule)."""
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import DistConfig
    return DistConfig(BigJoinConfig(batch=batch, mode=mode,
                                    out_capacity=1 << 20), MESH_W,
                      route_capacity=max(4 * batch // MESH_W, 64),
                      balance=balance)


def _mesh_fields(r) -> tuple:
    return (r.count, r.proposals, r.intersections, r.steps, r.max_load,
            r.mean_load)


def _mesh_plan(name: str):
    from repro_torch.core.plan import make_plan
    return make_plan(query_of(name))


def mesh_host_run(name: str, rels, cfg, threads: int):
    """``distributed_join`` of query ``name`` on the host (the plain
    versions), in a process of its own that never touches the card:
    (result, seconds)."""
    import torch
    from repro_torch.core.distributed import distributed_join
    torch.set_num_threads(threads)
    t = time.time()
    r = distributed_join(_mesh_plan(name), rels, cfg=cfg, device="cpu")
    return r, time.time() - t


def mesh_card(label: str, name: str, rels, cfg, lex: bool) -> tuple:
    """``distributed_join`` of query ``name`` on the card, with the count
    the single-device engine's there; the run must launch the membership
    kernel (its ``_lex`` variant when ``lex``).  Returns (result,
    seconds, launches)."""
    from repro_torch import kernels
    from repro_torch.core.bigjoin import (BigJoinConfig, build_indices,
                                          run_bigjoin, seed_tuples_for)
    from repro_torch.core.distributed import distributed_join
    plan = _mesh_plan(name)
    kernels.reset_launches()
    sync()
    t = time.time()
    card = distributed_join(plan, rels, cfg=cfg, device=DEVICE)
    sync()
    card_s = time.time() - t
    counts = kernels.launches()
    single = run_bigjoin(plan, build_indices(plan, rels, device=DEVICE),
                         seed_tuples_for(plan, rels),
                         cfg=BigJoinConfig(batch=cfg.base.batch,
                                           seed_chunk=cfg.base.batch,
                                           mode="count"))
    member = counts["signed_member_lex" if lex else "signed_member"]
    log(f"  mesh {label} on the card: {_mesh_fields(card)} in "
        f"{card_s:.2f} s; single-device count {single.count}; member "
        f"launches {member}")
    if card.count != single.count:
        raise AssertionError(f"mesh {label}: count {card.count} != the "
                             f"single-device engine's {single.count}")
    if member <= 0:
        raise AssertionError(f"mesh {label}: no membership-kernel launch "
                             f"({counts})")
    return card, card_s, counts


def mesh_compare(label: str, card, host, host_s: float) -> None:
    """The card's and the host's runs bit for bit: every field, and each
    worker's tuples and weights in order."""
    same = (_mesh_fields(card) == _mesh_fields(host)
            and np.array_equal(card.worker_rows, host.worker_rows)
            and card.tuples.dtype == host.tuples.dtype
            and np.array_equal(card.tuples, host.tuples)
            and np.array_equal(card.weights, host.weights))
    log(f"  mesh {label}: (count, proposals, intersections, steps, "
        f"max_load, mean_load) host {_mesh_fields(host)} in {host_s:.2f} "
        f"s; rows by worker {card.worker_rows.tolist()}; card bit for bit "
        f"the host: {same}")
    if not same:
        raise AssertionError(f"mesh {label}: the card's distributed join "
                             f"differs from the host's")


def mesh_scale_run(label: str, plan, rels, indices, cfg) -> tuple:
    """One timed ``distributed_join`` on the card over prebuilt shards,
    step MESH_PROFILED_STEP under the profiler.  Returns (result, record,
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.distributed import distributed_join
    prof = {}

    def hook(i, run):
        if i != MESH_PROFILED_STEP:
            return run()
        box = []
        prof["wall"], prof["busy"], prof["idle"], rec, exp = idle_share(
            lambda: box.append(run()))
        prof["recorded"] = [rec, exp]
        return box[0]

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    sync()
    t = time.time()
    r = distributed_join(plan, rels, cfg=cfg, device=DEVICE,
                         indices=indices, step_hook=hook)
    sync()
    secs = time.time() - t
    counts = kernels.launches()
    rec = dict(
        seconds=secs, steps=r.steps, count=r.count, proposals=r.proposals,
        intersections=r.intersections, max_load=r.max_load,
        mean_load=r.mean_load,
        load_imbalance=r.max_load / max(r.mean_load, 1e-9),
        member_launches=counts["signed_member"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        run_peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
        profiled_step_ms=prof.get("wall", float("nan")) * 1e3,
        device_busy_ms=prof.get("busy", float("nan")) * 1e3,
        idle_share=prof.get("idle"),
        profiled_launches_recorded=prof.get("recorded"))
    log(f"  mesh {label}: " + json.dumps(rec))
    return r, rec, counts


def mesh_phase(graph, seed: int) -> dict:
    """(a) ``distributed_join`` at w = MESH_W on the card against the host
    at R-MAT scale MESH_PARITY_SCALE: triangle plain and with Balance,
    4-clique-tri over the scale's ``tri`` relation, and (composite keys,
    the ``_lex`` membership kernel) 5-clique-quad over the ``quad``
    relation of scale MESH_QUAD_SCALE; (b) the triangle count over
    ``graph`` (R-MAT scale MESH_SCALE) at B' = MESH_BATCH a worker, plain
    and balanced, each equal to the single-device engine's count on the
    card, with every shard entry owned exactly once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.data.synthetic import rmat_graph
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    tri_plan = _mesh_plan("triangle")
    g10 = rmat_graph(MESH_PARITY_SCALE, 16, seed=seed)
    tri10, tri_s = relation_rows(g10, "tri", None)
    g6 = rmat_graph(MESH_QUAD_SCALE, 16, seed=seed)
    quad6, quad_s = relation_rows(g6, "quad", None)
    log(f"  mesh: scale {MESH_PARITY_SCALE} |E|={g10.shape[0]}, tri "
        f"{tri10.shape[0]} rows ({tri_s:.2f} s); scale {MESH_QUAD_SCALE} "
        f"|E|={g6.shape[0]}, quad {quad6.shape[0]} rows ({quad_s:.2f} s)")
    B = MESH_PARITY_BATCH
    cases = (
        ("triangle", "triangle", {"edge": g10}, _mesh_cfg(B, "collect"),
         False),
        ("triangle balance", "triangle", {"edge": g10},
         _mesh_cfg(B, "collect", balance=True), False),
        ("4-clique-tri", "4-clique-tri", {"tri": tri10},
         _mesh_cfg(4 * B, "collect"), False),
        ("5-clique-quad", "5-clique-quad", {"edge": g6, "quad": quad6},
         _mesh_cfg(B, "collect"), True))
    # the host's plain runs take most of the phase: they run in a process
    # of their own (spawned: it never touches the card) on half the
    # host's cores, beside the card's runs, and are compared at the end
    threads = max(1, (os.cpu_count() or 2) // 2)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        host = [pool.submit(mesh_host_run, name, rels, cfg, threads)
                for _l, name, rels, cfg, _x in cases]
        cards = []
        for label, name, rels, cfg, lex in cases:
            card, _s, counts = mesh_card(label, name, rels, cfg, lex)
            add(counts)
            cards.append(card)
        mesh_scale(graph, tri_plan, add)
        t = time.time()
        for (label, *_), card, fut in zip(cases, cards, host):
            mesh_compare(label, card, *fut.result(timeout=600))
        log(f"  mesh: waited {time.time() - t:.2f} s for the host's runs")
    return totals


def mesh_scale(graph, tri_plan, add) -> None:
    """The triangle count of ``graph`` at w = MESH_W, plain and balanced,
    against the single-device engine's; every shard entry owned once."""
    import torch
    from repro_torch.core import csr
    from repro_torch.core.bigjoin import (BigJoinConfig, build_indices,
                                          run_bigjoin, seed_tuples_for)
    from repro_torch.core.distributed import partition_indices
    rels = {"edge": graph}
    t = time.time()
    indices = partition_indices(tri_plan, rels, MESH_W, device=DEVICE)
    shard_s = time.time() - t
    per_worker = torch.zeros(MESH_W, dtype=torch.int64, device=DEVICE)
    for index_id, rel, key_pos, ext_pos, _v in tri_plan.index_ids():
        vi = indices[index_id]
        whole = csr.build_index(rels[rel], key_pos, ext_pos, device=DEVICE)
        if vi.live_entries() != int(whole.n):
            raise AssertionError(f"mesh: {index_id} holds "
                                 f"{vi.live_entries()} entries over its "
                                 f"shards, the relation {int(whole.n)}")
        for d in vi.pos + vi.neg:
            per_worker += d.n.to(torch.int64)
    per_worker = per_worker.cpu().numpy()
    log(f"  mesh: scale {MESH_SCALE} |E|={graph.shape[0]} sharded over "
        f"{MESH_W} workers in {shard_s:.2f} s; every entry owned once; "
        f"live entries by worker {per_worker.tolist()} (max "
        f"{int(per_worker.max())}, mean {float(per_worker.mean())})")
    sync()
    t = time.time()
    single = run_bigjoin(tri_plan, build_indices(tri_plan, rels,
                                                 device=DEVICE),
                         seed_tuples_for(tri_plan, rels),
                         cfg=BigJoinConfig(batch=MESH_BATCH,
                                           seed_chunk=MESH_BATCH,
                                           mode="count"))
    sync()
    log(f"  mesh: single-device triangle count {single.count} "
        f"({single.steps} steps, {time.time() - t:.2f} s)")
    runs = {}
    for label, bal in (("plain", False), ("balanced", True)):
        r, rec, counts = mesh_scale_run(
            f"scale {MESH_SCALE} {label}", tri_plan, rels, indices,
            _mesh_cfg(MESH_BATCH, "count", balance=bal))
        add(counts)
        if r.count != single.count:
            raise AssertionError(f"mesh scale {MESH_SCALE} {label}: count "
                                 f"{r.count} != the single-device "
                                 f"engine's {single.count}")
        if rec["member_launches"] <= 0:
            raise AssertionError(f"mesh scale {MESH_SCALE} {label}: no "
                                 f"membership-kernel launch")
        runs[label] = rec
    out = dict(workers=MESH_W, scale=MESH_SCALE, batch=MESH_BATCH,
               route_capacity=max(4 * MESH_BATCH // MESH_W, 64),
               edges=int(graph.shape[0]), count=single.count,
               single_device_steps=single.steps,
               live_entries_max=int(per_worker.max()),
               live_entries_mean=float(per_worker.mean()), runs=runs)
    log("  mesh: " + json.dumps(out))


# ---------------------------------------------------------------------------
# the mesh stream: Delta-BiGJoin over the worker-sharded store (§4), the
# mesh GraphSession on the card
# ---------------------------------------------------------------------------

STREAM_W = 4
STREAM_SCALE = 10  # (a) card against host: triangle, diamond
STREAM_NARY_SCALE = 9  # (a) the §5.4 pair: tri from triangle, 4-clique-tri
STREAM_EPOCHS = 4
STREAM_BATCH = 256
REAL_SCALE = 18  # (b) the pool's graph (20, the serve 20 cell's, ran
# past the script's budget on a slow host: PERF.md §4)
REAL_BATCH = 2048
REAL_EPOCHS = 6  # plain, then REAL_BALANCED epochs balanced
REAL_BALANCED = 3
# the fold kernel's worker axis: the workers' delta rows are dropped on
# this one, so one worker folds an empty delta
EMPTY_WORKER = 2
# processes of their own on the card, started beside the verify cells:
# (label, module, arguments, what a passing run prints)
MESH_CHILDREN = (
    ("delta_dist_check", "repro_torch.core._delta_dist_check",
     ["--workers", "4", "--batches", "8"], '"all_exact": true'),
    ("nary_dist_check", "repro_torch.core._nary_dist_check",
     ["--workers", "4", "--batches", "6"], '"all_exact": true'),
    ("run_query distributed", "repro_torch.launch.run_query",
     ["--mode", "distributed", "--workers", "4", "--scale", "10",
      "--verify"], "oracle ✓"),
    ("serve_check mesh chaos", "repro_torch.serve._serve_check",
     ["--chaos", "--tenants", "2", "--workers", "4", "--epochs", "12",
      "--faults", "dist.program@3,dist.program@11,store.commit.fold@6"],
     '"oracle_exact": true'),
) + tuple(
    # the serving pool over R = 2 gloo ranks, every rank on the card:
    # modes A and C as jobs of torch.distributed.run, mode B a process
    # that starts its jobs (each exits 0 only when its checks held)
    (f"serve_check ranks {label}", module, head + args, mark)
    for label, module, head, args, mark in (
        ("pool", "torch.distributed.run", ["--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.serve._serve_check"],
         ["--epochs", "8"], '"oracle_exact": true'),
        ("supervise", "repro_torch.serve._serve_check",
         ["--supervise", "--ranks", "2"],
         ["--epochs", "8", "--kill-at", "5"], '"all_exact": true'),
        ("chaos", "torch.distributed.run", ["--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.serve._serve_check"],
         ["--chaos", "--epochs", "12", "--faults",
          "dist.program@3,store.commit.fold@6,pool.apply@4,wal.append@2,"
          "snapshot.write@1"], '"oracle_exact": true'))
    for args in [args + ["--backend", "gloo", "--tenants", "2", "--workers",
                         "4"]])


# the mesh across processes: each harness as one process on the card and as
# R ranks of torch.distributed on the card (python -m torch.distributed.run);
# (case, module, arguments, what a passing run prints).  RANK_PARITY runs
# beside the verify cells at a small size, a case at a time, and its times
# are not compared.  RANK_TIMED is phase 21 (``--ranks-only``): each run
# alone at the mesh phase's count size and the mesh stream's update batch;
# the one process's count and tuples are held to Generic Join's, and the
# ranked runs skip that oracle and are held to the one process's line, as
# are the delta's (an epoch's full recomputation on the host takes ~10 s
# at this size).  It takes 220-330 s, which the default run's 1,200 s
# limit has no room for on a slow host.
RANK_W = 4
RANK_SMALL = ["--workers", str(RANK_W), "--nv", "2048", "--ne", "16384",
              "--batch", "1024"]
RANK_PARITY = (
    ("dist", "repro_torch.core._dist_check",
     RANK_SMALL + ["--route-capacity", "1024"], '"dist_count"'),
    ("dist balance", "repro_torch.core._dist_check",
     RANK_SMALL + ["--route-capacity", "1024", "--balance"],
     '"dist_count"'),
    ("delta", "repro_torch.core._delta_dist_check",
     RANK_SMALL + ["--batches", "4", "--batch-size", "1024"], '"epochs"'),
)
RANK_TIMED = (
    ("dist", "repro_torch.core._dist_check",
     ["--workers", str(RANK_W), "--rmat-scale", str(MESH_SCALE), "--batch",
      str(MESH_BATCH), "--route-capacity",
      str(max(4 * MESH_BATCH // RANK_W, 64)), "--out-capacity",
      str(1 << 22)], '"dist_count"'),
    ("delta", "repro_torch.core._delta_dist_check",
     ["--workers", str(RANK_W), "--rmat-scale", str(MESH_SCALE),
      "--batches", "4", "--batch-size", str(REAL_BATCH), "--batch", "512",
      "--no-check"], '"epochs"'),
)


def rank_children(cases, cards: int):
    """The runs of ``cases`` in order, each a child of
    :func:`start_children` with its (case, ranks, backend): every case as
    one process, then as R = 2 and R = 4 gloo ranks; NCCL (one rank a
    card) where there are two cards or more."""
    meshes = [(2, "gloo"), (4, "gloo")] + [
        (r, "nccl") for r in (2, 4) if cards >= r]
    out = []
    for case, module, args, mark in cases:
        out.append(((f"{case} one process", module, args, mark),
                    (case, 1, None)))
        extra = [] if "--no-check" in args else ["--no-check"]
        for ranks, backend in meshes:
            out.append(((f"{case} R={ranks} {backend}",
                         "torch.distributed.run",
                         ["--standalone", "--nproc-per-node", str(ranks),
                          "-m", module] + args + extra
                         + ["--backend", backend], mark),
                        (case, ranks, backend)))
    return out


def start_ranks(root: str, runs) -> dict:
    # one host thread a process, as torch.distributed.run gives a rank
    return start_children(root, [child for child, _ in runs],
                          OMP_NUM_THREADS="1")


def finish_rank_runs(procs: dict, runs) -> dict:
    """Wait for ``runs`` (started by :func:`start_ranks`): label -> (case,
    ranks, backend, rank 0's line, seconds)."""
    outs = {}
    secs = finish_children(procs, [child for child, _ in runs],
                           "mesh ranks", outs)
    got = {}
    for (label, *_), meta in runs:
        lines = [ln for ln in outs[label].splitlines() if ln.startswith("{")]
        if len(lines) != 1:
            raise AssertionError(f"mesh ranks: {label} printed "
                                 f"{len(lines)} lines, not one")
        got[label] = meta + (json.loads(lines[0]), secs[label])
    return got


DIST_FIELDS = ("dist_count", "proposals", "intersections", "steps",
               "max_load", "mean_load", "worker_rows", "tuples_sha")
# the kernels each case must launch on every rank: the services'
# membership kernel, and the store's commit fold over the worker axis
RANK_KERNELS = {"dist": ("signed_member",),
                "dist balance": ("signed_member",),
                "delta": ("signed_member", "commit_fold_w")}


def parity_runs(root: str, cards: int) -> dict:
    """``RANK_PARITY``'s runs, a case at a time: its one process and its
    ranks at once."""
    runs = {}
    for case in RANK_PARITY:
        group = rank_children((case,), cards)
        runs.update(finish_rank_runs(start_ranks(root, group), group))
    return runs


def ranks_only() -> int:
    """``--ranks-only``: the build, then phase 21."""
    import torch
    from repro_torch.kernels import _build
    root = os.path.dirname(os.path.abspath(__file__))
    with phase("build"):
        _build.build(force=True)
    with phase("mesh ranks"):
        ranks_phase(root, torch.cuda.device_count())
    with phase("mesh ranks serve"):
        ranks_serve_phase(root, torch.cuda.device_count())
    return 0


# phase 21's durable serving across ranks: two tenants of the mesh
# stream's R-MAT scale-18 graph at w = 4, 6 epochs of 2,048 dirty updates,
# a snapshot every 4 epochs, each run alone: one process, then R = 2
# ranks uninterrupted, killed right after tenant t1's WAL append of epoch
# RANK_KILL_AT, and resumed from that directory
RANK_SERVE = ["-m", "repro_torch.serve._serve_check", "--workers",
              str(RANK_W), "--tenants", "2", "--rmat-scale",
              str(REAL_SCALE), "--epochs", "6", "--batch-size",
              str(REAL_BATCH), "--update-batch", str(REAL_BATCH),
              "--snapshot-every", "4", "--no-oracle"]
RANK_KILL_AT = 5


def ranks_serve_phase(root: str, cards: int) -> dict:
    """The durable pool at size as one process and over R = 2 ranks
    (gloo, every rank on the card; NCCL, a rank a card, where there are
    two cards): every epoch's delta and the final state (the live edges
    and every leaf of each tenant's gathered snapshot) of the ranked run
    and of the resumed one equal the one process's, the victim's WAL ends
    at the killed epoch; snapshot gather, restore scatter and replay
    seconds, apply ms p50 against one process, the bytes a rank sends for
    the snapshots and each rank's device bytes (1/R of one process's),
    beside the card's name and power limit."""
    import shutil
    from repro_torch.serve import WriteAheadLog
    smi = nvidia_smi_line()
    base = os.path.join(root, "build", "ranks_serve")
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")

    def run(label, argv, killed=False):
        t0 = time.time()
        p = subprocess.run([sys.executable] + argv, env=env, cwd=root,
                           capture_output=True, text=True, timeout=900)
        secs = time.time() - t0
        log(f"  ranks serve {label}: rc {p.returncode}, {secs:.2f} s")
        if (p.returncode != 0) != killed:
            log(f"    stderr: {p.stderr[-3000:]}")
            raise AssertionError(f"ranks serve: {label} exited "
                                 f"{p.returncode}")
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if killed:
            return None
        if len(lines) != 1:
            raise AssertionError(f"ranks serve: {label} printed "
                                 f"{len(lines)} lines, not one")
        return json.loads(lines[0])

    one = run("one process", RANK_SERVE + [
        "--durable-dir", os.path.join(base, "one")])
    out = {"one": one["timing"]}
    for backend in ["gloo"] + (["nccl"] if cards >= 2 else []):
        job = ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2"] + RANK_SERVE + ["--backend",
                                                        backend]
        d = os.path.join(base, backend)
        whole = run(f"R=2 {backend}", job + [
            "--durable-dir", os.path.join(d, "whole")])
        run(f"R=2 {backend} killed after t1's WAL append of epoch "
            f"{RANK_KILL_AT}", job + [
                "--durable-dir", os.path.join(d, "victim"), "--kill-at",
                str(RANK_KILL_AT), "--kill-tenant", "t1"], killed=True)
        wal = WriteAheadLog.verify(os.path.join(d, "victim", "t1",
                                                "wal.log"))
        if wal["last_epoch"] != RANK_KILL_AT:
            raise AssertionError(f"ranks serve: the victim's WAL {wal}")
        resumed = run(f"R=2 {backend} resumed", job + [
            "--durable-dir", os.path.join(d, "victim")])
        for label, rec in (("uninterrupted", whole), ("resumed", resumed)):
            if rec["final"] != one["final"]:
                raise AssertionError(f"ranks serve: {backend} {label} final "
                                     f"{rec['final']} != one process's "
                                     f"{one['final']}")
            for n, per in rec["digests"].items():
                if any(one["digests"][n].get(e) != dg
                       for e, dg in per.items()):
                    raise AssertionError(f"ranks serve: {backend} {label} "
                                         f"{n} deltas differ")
        if min(resumed["starts"].values()) < RANK_KILL_AT - 1 or \
                resumed["replayed"] < 1:
            raise AssertionError(f"ranks serve: no recovery in {resumed}")
        t, tr, t1 = whole["timing"], resumed["timing"], one["timing"]
        if any(b * 2 != t1["device_bytes"][0] for b in t["device_bytes"]):
            raise AssertionError(f"ranks serve: device bytes "
                                 f"{t['device_bytes']} not half of "
                                 f"{t1['device_bytes']}")
        out[backend] = {"whole": t, "resumed": tr}
        log(f"  ranks serve: R=2 w={RANK_W} {backend}, scale {REAL_SCALE}, "
            f"2 tenants: every epoch and the final state (edges, every "
            f"snapshot leaf) equal to one process, uninterrupted and "
            f"resumed (starts {resumed['starts']}, {resumed['replayed']} "
            f"WAL epochs replayed); snapshot gather s {t['snapshot_s']}, "
            f"one process {t1['snapshot_s']}; restore scatter s "
            f"{tr['restore_s']}; replay s {tr['replay_s']}; apply ms p50 "
            f"{t['apply_ms_p50']} against {t1['apply_ms_p50']} in one "
            f"process; snapshot bytes a rank sends {t['snapshot_bytes']} "
            f"(restore {tr['restore_bytes']}); device bytes a rank "
            f"{t['device_bytes']} of {t1['device_bytes']}; {smi}")
    if cards < 2:
        log(f"  ranks serve: NCCL not run: this machine has {cards} card; "
            f"{smi}")
    return out


def ranks_phase(root: str, cards: int) -> dict:
    """Every run of ``RANK_TIMED``, one at a time with nothing beside
    it, held by :func:`finish_ranks`."""
    runs = {}
    for run in rank_children(RANK_TIMED, cards):
        runs.update(finish_rank_runs(start_ranks(root, [run]), [run]))
    return finish_ranks(runs, cards, timed=True)


def finish_ranks(runs: dict, cards: int, timed: bool) -> dict:
    """Hold every rank run to its one-process run on the card and print
    a ``mesh ranks:`` line for each, the card's name and power limit
    beside its numbers (the times only when the runs were ``timed``:
    alone).  Every rank of a run must have launched its case's kernels
    (``RANK_KERNELS``, counted in the harnesses' measured runs).  Returns
    the launches of every run, summed over its ranks."""
    smi = nvidia_smi_line()
    total = {}
    for label, (case, ranks, _b, rec, _s) in runs.items():
        got = rec["launches"]
        if any(len(got.get(k, [])) != ranks or min(got[k]) < 1
               for k in RANK_KERNELS[case]):
            raise AssertionError(f"mesh ranks: {label} launched {got}, not "
                                 f"{RANK_KERNELS[case]} on every rank")
        for k, v in got.items():
            total[k] = total.get(k, 0) + sum(v)
    for label, (case, ranks, backend, rec, secs) in runs.items():
        one = runs[f"{case} one process"][3]
        if case == "delta":
            got = [(e["count_delta"], e["sha"]) for e in rec["epochs"]]
            want = [(e["count_delta"], e["sha"]) for e in one["epochs"]]
            unit, per, nbytes, what, n = "epoch", "an epoch", \
                "store_bytes", "store", len(rec["epochs"])
            t, t1 = (sum(e["elapsed_s"] for e in r["epochs"])
                     for r in (rec, one))
        else:
            got = [rec[f] for f in DIST_FIELDS]
            want = [one[f] for f in DIST_FIELDS]
            unit, per, nbytes, what, n = "step", "a step", "index_bytes", \
                "index", max(rec["steps"], 1)
            t, t1 = rec["warm_s"], one["warm_s"]
        if got != want:
            raise AssertionError(f"mesh ranks: {label} differs from one "
                                 f"process: {got} against {want}")
        one_total = one[nbytes][0]
        if any(b * ranks != one_total for b in rec[nbytes]):
            raise AssertionError(f"mesh ranks: {label} {what} bytes "
                                 f"{rec[nbytes]} are not 1/{ranks} of one "
                                 f"process's {one_total}")
        ms = rec[f"exchange_ms_per_{unit}"]
        line = (f"  mesh ranks: R={ranks} w={rec['workers']} "
                f"{backend or 'one process'} {case}: "
                f"{'' if ranks == 1 else 'equal to one process; '}"
                f"exchange bytes a rank {per} "
                f"{rec[f'exchange_bytes_per_{unit}']}, exchange ms {per} "
                f"{[round(x, 3) for x in ms]}, {what} bytes a rank "
                f"{rec[nbytes]} of {one_total}, launches a rank "
                f"{rec['launches']}")
        if timed:
            line += (f", {'epochs' if unit == 'epoch' else 'count'} in "
                     f"{t:.3f} s against {t1:.3f} s in one process, the "
                     f"exchange's share {max(ms) * n / 1e3 / t:.3f} "
                     f"(slowest rank); {secs:.2f} s of process")
        else:
            line += " (beside the verify cells: times not compared)"
        log(f"{line}; {smi}")
    if cards < 2:
        log(f"  mesh ranks: NCCL not run: this machine has {cards} card, "
            f"and NCCL puts at most one rank on a card; {smi}")
    return total


def folds_of(store, res) -> int:
    """Commit-fold calls one epoch made: a relation's live-set fold and
    each of its non-derived projections' folds, for every relation the
    epoch's batch changed (each is ONE launch of the worker axis)."""
    n = 0
    for rel, (ins, dels) in res.by_rel.items():
        if ins.size or dels.size:
            n += 1 + sum(1 for r in store.projections.values()
                         if r.rel == rel and not r.derived)
    return n


def _delta_rec(d):
    return (None if d.tuples is None else d.tuples,
            None if d.weights is None else d.weights, int(d.count_delta))


def mesh_stream_run(case: str, edges, device: str, threads: int = 0):
    """One card-against-host case of the mesh stream on ``device``:
    ``plain``/``balanced`` triangle and diamond over ``edges``, or
    ``nary``, triangle feeding ``tri`` and 4-clique-tri over it.  Returns
    (per-epoch deltas of every query, final snapshot, seconds, fold calls,
    launches); on the host it runs in a process of its own."""
    import torch
    from repro_torch import kernels
    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.launch.mesh import make_host_mesh
    if threads:
        torch.set_num_threads(threads)
    nv = int(edges.max()) + 1
    s = GraphSession(edges, device=device,
                     mesh=make_host_mesh(STREAM_W, device),
                     update_batch=STREAM_BATCH,
                     balance=case == "balanced")
    if case == "nary":
        tri0, _ = s.register("triangle").enumerate()
        s.add_relation("tri", tri0)
        s.register("4-clique-tri")
    else:
        s.register("triangle")
        s.register("diamond")
    s.prewarm()
    stream = EdgeUpdateStream(nv, STREAM_BATCH, seed=7)
    live = s.edges
    kernels.reset_launches()
    out, folds = [], 0
    t = time.time()
    for step in range(STREAM_EPOCHS):
        upd, w = stream.batch_at(step, live=live)
        r1 = s.update(upd, w)
        folds += folds_of(s.store, r1)
        live = r1.advance(live)
        rec = {n: _delta_rec(d) for n, d in r1.deltas.items()
               if n != "4-clique-tri"}
        if case == "nary":
            r2 = s.update({"tri": feed_of(r1.deltas["triangle"], 3)})
            folds += folds_of(s.store, r2)
            rec["4-clique-tri"] = _delta_rec(r2.deltas["4-clique-tri"])
        out.append(rec)
    if device != "cpu":
        sync()
    secs = time.time() - t
    return out, s.snapshot(), secs, folds, kernels.launches(), s


def _host_stream(case, edges, threads):
    out, snap, secs, folds, _l, _s = mesh_stream_run(case, edges, "cpu",
                                                     threads)
    return out, snap, secs, folds


def mesh_stream_compare(case, card, host) -> None:
    """Card and host bit for bit: every epoch's tuples and weights in
    order and count_delta of every query, and the final snapshot."""
    (c_out, (cl, cm), c_s, c_folds), (h_out, (hl, hm), h_s, h_folds) = \
        card, host

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        return a.dtype == b.dtype and np.array_equal(a, b)
    ok = len(c_out) == len(h_out) and all(
        ce.keys() == he.keys() and all(
            same(ce[n][0], he[n][0]) and same(ce[n][1], he[n][1])
            and ce[n][2] == he[n][2] for n in ce)
        for ce, he in zip(c_out, h_out))
    snap_ok = json.dumps(cm, sort_keys=True) == \
        json.dumps(hm, sort_keys=True) and len(cl) == len(hl) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(cl, hl))
    rows = [{n: (0 if d[0] is None else int(d[0].shape[0]), d[2])
             for n, d in e.items()} for e in c_out]
    log(f"  mesh stream {case}: card {c_s:.2f} s, host {h_s:.2f} s; "
        f"(rows, count_delta) by epoch {rows}; epochs bit for bit {ok}, "
        f"snapshot ({len(cl)} leaves) bit for bit {snap_ok}; fold calls "
        f"card {c_folds} host {h_folds}")
    if not (ok and snap_ok and c_folds == h_folds):
        raise AssertionError(f"mesh stream {case}: the card differs from "
                             f"the host")


def fold_w_row(record, name, store, proj, rows, label, reps, seed):
    """Kernel row of the fold's worker axis at a sharded store's own
    shapes: ``proj``'s base and committed regions, a delta of the store's
    pinned rung drawn from ``rows`` (the relation's live rows: deletes of
    live rows, inserts of absent ones) with worker EMPTY_WORKER's rows
    dropped, so one worker folds an empty delta.  The kernel is held to
    the plain version on host copies bit for bit, then timed as the other
    rows, against ``STREAM_W`` launches of the one-region kernel on the
    same shards."""
    from repro_torch.core import csr
    from repro_torch.core.delta import _degenerate_rows, rows_isin
    from repro_torch.kernels import _build
    from repro_torch.kernels.merge import fold as mfold
    w = store.shard_w
    reg = store.projections[proj]
    rng = np.random.default_rng(seed)
    P = store.ratchet.peek(("delta", reg.rel))
    n = P * w // 4  # a quarter of every worker's rung, on average
    dels = rows[rng.choice(rows.shape[0], n, replace=False)]
    cand = rows[rng.choice(rows.shape[0], 2 * n)].copy()
    cand[:, -1] = rng.integers(0, int(rows.max()) + 1, 2 * n)
    cand = cand[~_degenerate_rows(cand) & ~rows_isin(cand, rows)][:n]

    def delta(r):
        key = csr.pack_key(tuple(r[:, p] for p in reg.key_pos))
        r = r[csr.shard_of(key, w) != EMPTY_WORKER]
        return csr.build_sharded_index(r, reg.key_pos, reg.ext_pos, w,
                                       capacity=P, narrow=reg.narrow,
                                       device=DEVICE)
    ui, ud = delta(np.unique(cand, axis=0)), delta(np.unique(dels, axis=0))
    ba, ci, cd = reg.d_base, reg.d_cins, reg.d_cdel
    need = int(max((ci.n + ui.n).max(), (cd.n + ud.n).max()))
    cc = max(csr.pow2_capacity(need), ci.key.shape[-1])

    def fold_k():
        return mfold.commit_fold(ci, cd, ui, ud, base=ba, cins_cap=cc,
                                 cdel_cap=cc, sharded=True)

    def fold_p():
        return mfold._commit_fold_sharded_ref(ci, cd, ui, ud, ba, cc, cc)

    def one_region():
        return [mfold.commit_fold(csr.shard_view(ci, k), csr.shard_view(cd, k),
                                  csr.shard_view(ui, k), csr.shard_view(ud, k),
                                  base=csr.shard_view(ba, k), cins_cap=cc,
                                  cdel_cap=cc) for k in range(w)]

    def host(d):
        return csr.IndexData(*(None if x is None else x.cpu()
                               for x in (d.key, d.val, d.n, d.lo)))
    got = fold_k()
    want = mfold._commit_fold_sharded_ref(*map(host, (ci, cd, ui, ud, ba)),
                                          cc, cc)
    sync()
    err = max_abs_err([host(g) for g in got], want)
    if int(ui.n[EMPTY_WORKER]) or int(ud.n[EMPTY_WORKER]):
        raise AssertionError(f"{name}: worker {EMPTY_WORKER}'s delta is "
                             f"not empty")
    sep = one_region()
    for k, (a, b) in enumerate(sep):
        max_abs_err((a, b), (csr.shard_view(got[0], k), csr.shard_view(got[1], k)))
    ms = cuda_ms(fold_k, reps)
    dms = device_ms(fold_k, reps, name, names=("fold_kernel",))
    hus = host_us(fold_k, reps)
    pms = cuda_ms(fold_p, max(reps // 10, 2))
    one_ms = cuda_ms(one_region, reps)
    one_dms = device_ms(one_region, reps, name, names=("fold_kernel",),
                        per_call={"fold_kernel": w})
    nbytes = ops = 0
    for k in range(w):
        b, o = fold_work([csr.shard_view(r, k) for r in (ci, cd, ui, ud)], cc,
                         csr.shard_view(ba, k))
        nbytes, ops = nbytes + b, ops + o
    grid = _build.lib("fold").repro_commit_fold_grid_w(
        _build.region_desc([csr.shard_view(r, 0)
                            for r in (ci, cd, ui, ud, ba)]), 5,
        int(ba.lo is not None), cc, cc, w)
    caps = "/".join(str(r.key.shape[-1]) for r in (ci, cd, ui, ud))
    shape = (f"{label} w={w} caps={caps} base={ba.key.shape[-1]} out={cc} "
             f"delta n "
             f"{ui.n.tolist()}/{ud.n.tolist()} grid={grid}")
    record(name, err, ms, dms, pms, nbytes, ops, None, shape, main=True,
           host=hus)
    row = dict(kernel=name, ms=ms, device_ms=dms, host_us=hus,
               one_region_x_w_ms=one_ms, one_region_x_w_device_ms=one_dms,
               grid=grid, base_n=ba.n.tolist())
    log("  " + json.dumps({"commit_fold_worker_axis": row}))
    return row


def mesh_real_run(graph, table, reps, seed, add) -> dict:
    """(b) the triangle query streamed on a w = STREAM_W mesh session over
    ``graph`` (R-MAT scale REAL_SCALE), B' and the route from
    ``auto_sizing(num_workers=4)``: REAL_EPOCHS epochs plain, then the
    session's snapshot restored into a balanced mesh session for
    REAL_BALANCED more; every epoch's canonical delta equal to the
    one-device session's on the card over the same batches, every shard
    entry owned once.  Then the fold's worker-axis row over its store."""
    import torch
    from repro_torch import kernels
    from repro_torch.api import GraphSession
    from repro_torch.core import distributed as D
    from repro_torch.core.delta import canon_arrays
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(STREAM_W, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.time()
    s = GraphSession(graph, device=DEVICE, mesh=mesh,
                     update_batch=REAL_BATCH)
    h = s.register("triangle")
    s.prewarm()
    dcfg = h.engine.dcfg  # B' and the route: auto_sizing's, w = 4
    build_s = time.time() - t
    t = time.time()
    one = GraphSession(graph, device=DEVICE, update_batch=REAL_BATCH)
    one.register("triangle")
    one.prewarm()
    one_build_s = time.time() - t
    stream = EdgeUpdateStream(1 << REAL_SCALE, REAL_BATCH, seed=seed + 9)
    live = s.edges
    secs, one_secs, per_epoch, steps, loads = [], [], [], [], []
    profiled = None

    def epoch(sess, upd, w):
        sync()
        t0 = time.time()
        r = sess.update(upd, w)
        sync()
        return r, time.time() - t0

    # each program run's served load (requests each worker answered, Thm
    # 3.4), read off its outputs: (the max over the workers, the mean);
    # a failure ends the script, so the class is restored on success only
    runs = []
    program_call = D.DistributedProgram.__call__

    def recording(self, *args):
        out = program_call(self, *args)
        runs.append((out[5], out[6] / self.w))
        return out

    D.DistributedProgram.__call__ = recording
    for step in range(REAL_EPOCHS + REAL_BALANCED):
        if step == REAL_EPOCHS:  # the same store, now balanced
            leaves, meta = s.snapshot()
            t0 = time.time()
            s = GraphSession(graph[:1], device=DEVICE, mesh=mesh,
                             update_batch=REAL_BATCH, balance=True)
            s.restore(leaves, meta)
            s.prewarm()
            log(f"  mesh real: snapshot ({len(leaves)} leaves) restored "
                f"into a balanced session in {time.time() - t0:.2f} s")
            del leaves
        upd, w = stream.batch_at(step, live=live)
        before = kernels.launches()
        n_runs = len(runs)
        if step == REAL_EPOCHS - 1:  # one profiled plain epoch
            box = []
            wall, busy, idle, rec, exp = idle_share(
                lambda: box.append(s.update(upd, w)))
            r, dt = box[0], wall
            profiled = dict(ms=wall * 1e3, device_busy_ms=busy * 1e3,
                            idle_share=idle, launches_recorded=[rec, exp])
        else:
            r, dt = epoch(s, upd, w)
        after = kernels.launches()
        # the epoch's load: its plans' max and mean served loads summed
        loads.append([float(sum(x[i] for x in runs[n_runs:]))
                      for i in (0, 1)])
        per_epoch.append({k: after[k] - before[k] for k in after
                          if after[k] != before[k]})
        add({k: after[k] - before[k] for k in after})
        r1, dt1 = epoch(one, upd, w)
        d, d1 = r.deltas["triangle"], r1.deltas["triangle"]
        a = canon_arrays(d.tuples, d.weights, 3)
        b = canon_arrays(d1.tuples, d1.weights, 3)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"mesh real epoch {step}: the mesh's delta "
                                 f"differs from the one-device session's")
        secs.append(dt)
        one_secs.append(dt1)
        steps.append(sum(x.steps for x in d.per_dq))
        live = r.advance(live)
        tag = " (balanced)" if step >= REAL_EPOCHS else ""
        log(f"  mesh real epoch {step}{tag}: "
            f"{dt * 1e3:.1f} ms (one device {dt1 * 1e3:.1f} ms), "
            f"{0 if d.tuples is None else d.tuples.shape[0]} delta rows, "
            f"steps {steps[-1]}, max/mean load {loads[-1]}, launches "
            f"{per_epoch[-1]}")
    D.DistributedProgram.__call__ = program_call
    # every shard entry owned once, and each worker's live entries
    st = s.store
    per_worker = np.zeros(STREAM_W, np.int64)
    for rel in st.relations:
        lv = st._rels[rel]
        for idx in (lv.lb, lv.lc_ins, lv.lc_del):
            per_worker += idx.n.cpu().numpy()
        if int(lv.lb.n.sum() + lv.lc_ins.n.sum() - lv.lc_del.n.sum()) != \
                st.num_tuples(rel) or st.num_tuples(rel) != one.num_edges:
            raise AssertionError(f"mesh real: {rel}'s live set holds "
                                 f"{st.num_tuples(rel)} rows over its "
                                 f"shards, the one-device store "
                                 f"{one.num_edges}")
    for proj, reg in st.projections.items():
        if reg.derived:
            continue
        n = int(reg.d_base.n.sum() + reg.d_cins.n.sum()
                - reg.d_cdel.n.sum())
        for idx in (reg.d_base, reg.d_cins, reg.d_cdel):
            per_worker += idx.n.cpu().numpy()
        if n != st.num_tuples(reg.rel):
            raise AssertionError(f"mesh real: projection {proj} holds {n} "
                                 f"entries over its shards, the relation "
                                 f"{st.num_tuples(reg.rel)}")
    warm = np.asarray(secs[1:REAL_EPOCHS]) * 1e3
    bal = np.asarray(secs[REAL_EPOCHS + 1:]) * 1e3
    one_warm = np.asarray(one_secs[1:]) * 1e3
    folds = [e.get("commit_fold_w", 0) for e in per_epoch]
    out = dict(
        workers=STREAM_W, scale=REAL_SCALE, edges=int(graph.shape[0]),
        update_batch=REAL_BATCH, batch=dcfg.base.batch,
        route_capacity=dcfg.route_capacity,
        out_capacity=dcfg.base.out_capacity, build_s=build_s,
        one_device_build_s=one_build_s, first_epoch_ms=secs[0] * 1e3,
        epoch_p50_ms=float(np.percentile(warm, 50)),
        epoch_p99_ms=float(np.percentile(warm, 99)),
        balanced_first_ms=secs[REAL_EPOCHS] * 1e3,
        balanced_p50_ms=float(np.percentile(bal, 50)) if bal.size else None,
        one_device_p50_ms=float(np.percentile(one_warm, 50)),
        steps=steps, fold_launches_per_epoch=folds,
        load_max_mean_per_epoch=loads,
        load_imbalance={k: sum(x[0] for x in v) / max(sum(x[1] for x in v),
                                                      1e-9)
                        for k, v in (("plain", loads[:REAL_EPOCHS]),
                                     ("balanced", loads[REAL_EPOCHS:]))},
        member_launches_per_epoch=[e.get("signed_member", 0)
                                   + e.get("member", 0) for e in per_epoch],
        rank_launches_per_epoch=[e.get("rank_lt_le", 0) for e in per_epoch],
        live_entries_max=int(per_worker.max()),
        live_entries_mean=float(per_worker.mean()),
        compactions=st.stats.compactions,
        live_compactions=st.stats.live_compactions,
        escalations=st.stats.escalations,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        run_peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
        profiled_epoch=profiled)
    log("  mesh real: " + json.dumps(out))
    if any(f <= 0 for f in folds):
        raise AssertionError(f"mesh real: an epoch without a worker-axis "
                             f"fold launch: {folds}")
    # the worker axis's kernel row over this store (its launches are not
    # the main path's: the epochs' counts were read above)
    proj = next(p for p, r in st.projections.items() if not r.derived)
    fold_w_row(recorder(table), "commit_fold_w", st, proj, live,
               "mesh real", reps, seed)
    return out


def mesh_stream_phase(graph20, table, reps, seed) -> dict:
    """(a) at w = STREAM_W on the card against the host: triangle and
    diamond over R-MAT scale STREAM_SCALE, STREAM_EPOCHS epochs of
    STREAM_BATCH dirty updates, plain and balanced, and the §5.4 pair over
    R-MAT scale STREAM_NARY_SCALE; the host's runs each in a spawned
    process beside the card's, compared at the end; one worker-axis fold
    launch a relation or projection fold and epoch, the composite ``_lex``
    one for ``tri``; then the composite worker-axis kernel row over the
    §5.4 store. (b) ``mesh_real_run``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.data.synthetic import rmat_graph
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    graphs = {"plain": rmat_graph(STREAM_SCALE, 16, seed=seed),
              "nary": rmat_graph(STREAM_NARY_SCALE, 16, seed=seed)}
    graphs["balanced"] = graphs["plain"]
    cases = ("balanced", "plain", "nary")
    threads = max(1, (os.cpu_count() or 2) // 4)
    with ProcessPoolExecutor(
            len(cases), mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        host = {c: pool.submit(_host_stream, c, graphs[c], threads)
                for c in cases}
        card, nary_session = {}, None
        for c in cases:
            out, snap, secs, folds, counts, sess = mesh_stream_run(
                c, graphs[c], DEVICE)
            add(counts)
            fold = counts["commit_fold_w"] + counts["commit_fold_lex_w"]
            log(f"  mesh stream {c} on the card: {secs:.2f} s, worker-axis "
                f"fold launches {fold} (one-region {counts['commit_fold']}"
                f"+{counts['commit_fold_lex']}) for {folds} folds, member "
                f"{counts['signed_member'] + counts['member']}"
                f"+{counts['signed_member_lex'] + counts['member_lex']}, "
                f"rank {counts['rank_lt_le']}+{counts['rank_lt_le_lex']}")
            if fold != folds or counts["commit_fold"] or \
                    counts["commit_fold_lex"]:
                raise AssertionError(f"mesh stream {c}: {fold} worker-axis "
                                     f"fold launches for {folds} folds")
            if c == "nary" and not counts["commit_fold_lex_w"]:
                raise AssertionError("mesh stream nary: no composite "
                                     "worker-axis fold launch")
            card[c] = (out, snap, secs, folds)
            if c == "nary":
                nary_session = sess
        st = nary_session.store
        # the coverage gate on a sharded store: one worker-axis fold
        # launch a relation, the probe on worker 0's shard
        cov = nary_session.kernel_coverage()
        log(f"  mesh stream coverage (sharded, w = {STREAM_W}): "
            + json.dumps(cov))
        if any(c["fold_pallas_calls"] != 1 or c["probe_pallas_calls"] < 1
               for c in cov.values()) or not cov["tri"]["composite"]:
            raise AssertionError(f"mesh stream: sharded coverage {cov}")
        proj = next(p for p, r in st.projections.items()
                    if r.rel == "tri" and not r.derived)
        fold_w_row(recorder(table), "commit_fold_lex_w", st, proj,
                   st.relation_rows("tri"), "mesh stream tri", reps, seed)
        del nary_session, st
        real = mesh_real_run(graph20, table, reps, seed, add)
        t = time.time()
        for c in cases:
            mesh_stream_compare(c, card[c], host[c].result(timeout=900))
        log(f"  mesh stream: waited {time.time() - t:.2f} s for the host's "
            f"runs")
    return totals, real


# ---------------------------------------------------------------------------
# phases 14-15 and the flash rows of phase 3: the LM serving path (gemma2-2b;
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
LM_SMOKE_ARCHS = ("yi-34b", "gemma-7b", "gemma2-2b", "mixtral-8x7b",
                  "llama4-scout-17b-a16e")
# mixtral-8x7b at full width and depth 1 held card against host on one
# request of this many tokens (its MoE capacity 168 a expert)
LM_MOE_VERIFY_TOKENS = 520
# mixtral-8x7b training at full width: train_4k's 4,096-token sequences,
# depth cut 32 -> 2 (~3.03B parameters, 16 bytes each with the bf16
# gradient, the f32 accumulator and moments: ~48.5 GB), the batch cut
# from 256 x 8 microbatches to 8 x 4
LM_TRAIN_LAYERS = 2
LM_TRAIN_BATCH = 8
LM_TRAIN_MICRO = 4
LM_TRAIN_SEQ = 4096
LM_TRAIN_STEPS = 6  # 1 cold + 5 warm, then one profiled
LM_TRAIN_LR = 3e-4  # the default schedule's peak, held constant
# the first microbatch's bf16 loss, and each leaf's bf16 gradient norm,
# within these shares of the same parameters' f32 ones.  At random init
# the loss is ln(vocab) + ~0.5 whatever the hidden states (its gap
# measured 7.5e-05), so the gradient norms are what see the backward:
# every leaf but the tied embedding within 0.0113 of f32, the embedding's
# 0.101 below it (the JAX package's bf16 path shrinks it too, on 8,192
# tokens and more)
LM_LOSS_GAP = 1e-3
LM_GNORM_GAP = 0.03
LM_EMBED_GNORM_GAP = 0.2
# mixtral-8x7b serving: depth cut 32 -> 12 (~35 GB of bf16 parameters),
# 4 prompts of 4,096 tokens, so the 4,096 window masks keys in decode
LM_SERVE_MOE_LAYERS = 12
LM_SERVE_MOE_PROMPT = 4096
# card against host, f32 on both: matmuls and softmax sums in another
# order (cuBLAS against the host's BLAS, the kernel's online softmax
# against one softmax), |err| <= tol * max(1, max |host|): 2 layers at
# smoke width (the train steps too), 2 layers at full width (d 2304, ff
# 9216, 4,160 keys), 1 MoE layer at full width (d 4096, ff 14336)
LM_SMOKE_TOL = 1e-4
LM_FULL_TOL = 1e-3
# the train steps held card against host run at this constant learning
# rate, so every parameter moves by about that much (the default schedule
# is 0 at step 0; one case runs it, to cover its wiring); each moment is
# held at LM_SMOKE_TOL with an atol of LM_MOMENT_ATOL times its leaf's
# largest |moment|, and each parameter's change at LM_SMOKE_TOL with that
# atol carried through the steps' lr * m^ / (sqrt(v^) + eps), which turns
# a small gradient's rounding into a large part of its move, plus two ulps
# of the leaf's largest parameter
LM_VERIFY_LR = 1e-3
LM_MOMENT_ATOL = 1e-5
# decode against prefill at full depth in bf16 on the card, |err| <= tol *
# max |prefill logits|: both round every activation to bf16 (2^-8
# relative), through 26 layers whose matmuls have other shapes (4 rows
# against 4 x 8,193) and so other sum orders and roundings
LM_DECODE_TOL = 0.05


def _lm_arch(arch_id: str):
    from repro_torch.configs.lm_archs import LM_ARCHS
    return {a.arch_id: a for a in LM_ARCHS}[arch_id]


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
        pairs = qq.shape[0] * H * fops.live_pairs(
            qq.shape[1], kk.shape[1], True, window, q_offset)
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
               fops.kernel_ops(tuple(qq.shape), kk.shape[1], True, window,
                               q_offset), lib_ms, shape, main,
               BF16_OPS_PER_S,
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
    prefill; the card's flash launches per pass: none in forward and
    loss (they attend through ``_attend``, what training
    differentiates), ``num_layers`` in every prefill and decode step."""
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

        def counted(what, fn):
            kernels.reset_launches()
            res = fn()
            if dev == DEVICE:
                flash.append((what, kernels.launches()["flash_attention"]))
            return res
        with torch.no_grad():
            if not full:
                hidden, _aux = counted("forward", lambda: T.forward(m, tok))
                out["hidden"] = hidden
                out["logits"] = T.logits_fn(m, hidden)
                out["loss"], _ = counted("loss", lambda: T.loss_fn(m, {
                    "tokens": tok,
                    "labels": torch.from_numpy(labels).to(dev)}))
            logits, kv = counted("prefill", lambda: T.prefill(m, tok))
            out["prefill"] = logits
            out["prefill_k"] = kv["k"]
            cache = T.make_cache(cfg, B, S + n_dec, device=dev)
            cache["k"][:, :, :S] = kv["k"]
            cache["v"][:, :, :S] = kv["v"]
            del kv
            for j in range(n_dec):
                step = torch.from_numpy(decode_tokens[:, j:j + 1]).to(dev)
                lg, cache = counted("decode", lambda: T.decode_step(
                    m, cache, step, S + j))
                out[f"decode{j}"] = lg
            out["cache_k"] = cache["k"]
            out["cache_v"] = cache["v"]
        outs[dev] = out
    del model
    for key in outs["cpu"]:
        errs[key] = _lm_close(f"{cfg.name} {key}", outs[DEVICE][key],
                              outs["cpu"][key], tol)
    torch.cuda.empty_cache()
    want = {"forward": 0, "loss": 0, "prefill": cfg.num_layers,
            "decode": cfg.num_layers}
    if any(n != want[what] for what, n in flash):
        raise AssertionError(f"lm verify {cfg.name}: flash launches per "
                             f"pass {flash}, expected {want}")
    return dict(errs=errs, flash=[n for _, n in flash])


def lm_verify_phase(seed: int) -> dict:
    """The card against the host, f32 on both: the smoke configs of the
    five archs (forward, logits, loss, prefill and 4 decode steps past the
    window of 8), gemma2-2b at full width and depth 2 (one local, one
    global layer) on one 4,160-token request (prefill and 2 decode
    steps), so the 4096 window masks early keys, and mixtral-8x7b at full
    width and depth 1 (8 experts top-2) on one 520-token request (prefill
    and 2 decode steps).  Returns the kernel launches."""
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
    for arch, depth, S in (("gemma2-2b", 2, 4160),
                           ("mixtral-8x7b", 1, LM_MOE_VERIFY_TOKENS)):
        cfg = dataclasses.replace(
            _lm_arch(arch).full_config, name=f"{arch}-depth{depth}",
            num_layers=depth, param_dtype=torch.float32,
            act_dtype=torch.float32)
        b = TokenStream(cfg.vocab, 1, S + 2, seed).batch_at(0)
        t = time.time()
        out = _lm_verify(cfg, b[:, :S], None, b[:, S:S + 2], LM_FULL_TOL,
                         True, seed)
        add(out["flash"])
        log(f"  lm verify {cfg.name} (full width, {S:,} tokens): max |card "
            f"- host| {json.dumps(out['errs'])}, flash launches "
            f"{out['flash']} ({time.time() - t:.2f} s)")
    return totals


@contextlib.contextmanager
def kept_shares(into: list):
    """Record, while open, the share of each MoE call's token-expert
    assignments that its capacity keeps (``transformer._route``'s
    ``kept``), one a layer and pass, into ``into``: 0-d tensors on the
    card while open (no synchronise inside a timed pass), floats after."""
    from repro_torch.models import transformer as T
    route = T._route

    def recording(x2d, router, cfg):
        r = route(x2d, router, cfg)
        into.append(r["kept"].float().mean())
        return r
    T._route = recording
    try:
        yield into
    finally:
        T._route = route
        into[:] = [float(x) for x in into]


def _leaf_close(what, card, host, atol) -> float:
    """|card - host| <= atol + LM_SMOKE_TOL * |host| in every element
    (``atol`` a number or a tensor of the leaf's shape), or raise; returns
    the worst |err| / bound."""
    import torch
    c = card.detach().float().cpu()
    h = host.detach().float()
    if c.shape != h.shape:
        raise AssertionError(f"lm train verify {what}: shapes {c.shape} "
                             f"{h.shape}")
    err = (c - h).abs()
    bound = torch.as_tensor(atol, dtype=torch.float32) \
        + LM_SMOKE_TOL * h.abs()
    bad = ~(err <= bound)
    if bool(bad.any()):
        raise AssertionError(f"lm train verify {what}: card differs from "
                             f"host in {int(bad.sum())} of {err.numel()} "
                             f"elements (worst |err| {float(err[bad].max())})")
    return float((err / bound.clamp_min(1e-30)).max())


def lm_train_verify_phase(seed: int) -> dict:
    """``make_train_step`` on the card against the host, f32 on both, for
    the five archs' smoke configs at 1 and 2 microbatches, at the constant
    learning rate LM_VERIFY_LR, and mixtral at 1 on the default schedule:
    two steps from the same parameters on the same TokenStream batches;
    each step's loss and gradient norm at LM_SMOKE_TOL, then both AdamW
    moments and every parameter's change over the two steps (see
    LM_MOMENT_ATOL); no flash launch (training attends through
    ``_attend``).  Returns the launches."""
    import copy
    import torch
    from repro_torch import kernels
    from repro_torch.configs.lm_family import make_train_step, token_batch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant, cosine_decay
    totals = {}
    cases = [(a, M, LM_VERIFY_LR) for a in LM_SMOKE_ARCHS for M in (1, 2)]
    cases.append(("mixtral-8x7b", 1, None))
    for arch, M, lr in cases:
        cfg = _lm_arch(arch).smoke_config
        ts = TokenStream(cfg.vocab, 4, 32, seed)
        sched = constant(lr) if lr is not None \
            else cosine_decay(3e-4, 2000, 100_000)
        t = time.time()
        model = T.Transformer(cfg, seed=seed, device=DEVICE)
        host = copy.deepcopy(model).cpu()
        p0 = {k: p.detach().clone() for k, p in host.named_parameters()}
        runs, moments = {}, []
        for dev, m in ((DEVICE, model), ("cpu", host)):
            opt = adamw_init(m)
            step = make_train_step(cfg, schedule=sched if lr else None,
                                   microbatches=M)
            kernels.reset_launches()
            ms = []
            for s in range(2):
                ms.append(step(m, opt, token_batch(ts.batch_at(s), dev)))
                if dev == "cpu":
                    moments.append(({k: v.clone() for k, v in
                                     opt.mu.items()},
                                    {k: v.clone() for k, v in
                                     opt.nu.items()}))
            if dev == DEVICE:
                add_counts(totals, kernels.launches())
                flash = kernels.launches()["flash_attention"]
            runs[dev] = (m, opt, ms)
        (cm, copt, cms), (hm, hopt, hms) = runs[DEVICE], runs["cpu"]
        label = f"train {cfg.name} M={M} lr={lr or 'default'}"
        errs = {}
        for s in range(2):
            for k in ("loss", "gnorm"):
                errs[f"{k}{s}"] = _lm_close(f"{label} {k} step {s}",
                                            cms[s][k], hms[s][k],
                                            LM_SMOKE_TOL)
        for what, card, hst in (("mu", copt.mu, hopt.mu),
                                ("nu", copt.nu, hopt.nu)):
            errs[what] = max(_leaf_close(
                f"{label} {what} {k}", card[k], hst[k],
                LM_MOMENT_ATOL * float(hst[k].abs().max())) for k in hst)
        cp, worst = dict(cm.named_parameters()), 0.0
        for k, p in hm.named_parameters():
            moved = p.detach() - p0[k]
            got = cp[k].detach().cpu() - p0[k]
            if lr and not (float(moved.abs().max()) > 0.5 * lr
                           and float(got.abs().max()) <= 3 * lr):
                raise AssertionError(f"{label} {k}: moved "
                                     f"{float(moved.abs().max())} on the "
                                     f"host, {float(got.abs().max())} on "
                                     f"the card, at lr {lr}")
            atol = 2 * float(np.spacing(np.float32(p0[k].abs().max())))
            for n, (mu, nu) in enumerate(moments, 1):
                atol = atol + float(sched(n - 1)) * LM_MOMENT_ATOL \
                    * float(mu[k].abs().max()) / (1 - 0.9 ** n) \
                    / ((nu[k] / (1 - 0.95 ** n)).sqrt() + 1e-8)
            worst = max(worst, _leaf_close(f"{label} param change {k}",
                                           got, moved, atol))
        errs["param_change"] = worst
        if copt.step != hopt.step or copt.step != 2 or flash:
            raise AssertionError(f"{label}: steps {copt.step}/"
                                 f"{hopt.step}, flash launches {flash}")
        log(f"  lm {label}: loss "
            f"{[float(x['loss']) for x in cms]}, max |card - host| "
            f"(moments and changes: the worst share of their bound) "
            f"{json.dumps(errs)} ({time.time() - t:.2f} s)")
    return totals


def lm_train_phase(seed: int) -> dict:
    """mixtral-8x7b at full width (8 experts top-2, window 4096), depth
    LM_TRAIN_LAYERS, bf16 parameters and activations, f32 moments and
    gradient accumulator: first the loss and each leaf's gradient norm of
    the first microbatch in bf16 against the same parameters cast to f32
    (within LM_LOSS_GAP, LM_GNORM_GAP and LM_EMBED_GNORM_GAP), with the
    share of assignments each layer keeps; then LM_TRAIN_STEPS steps at
    the constant rate LM_TRAIN_LR of LM_TRAIN_BATCH sequences of
    LM_TRAIN_SEQ tokens in LM_TRAIN_MICRO microbatches and one profiled
    step: step ms, tokens/s,
    peak memory of the steps, idle share; every loss and gradient norm
    finite; every weight matrix moved; no flash launch.  Returns the
    launches."""
    import copy
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs.lm_family import make_train_step, token_batch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant
    cfg = dataclasses.replace(_lm_arch("mixtral-8x7b").full_config,
                              num_layers=LM_TRAIN_LAYERS)
    B, M, S = LM_TRAIN_BATCH, LM_TRAIN_MICRO, LM_TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.time()
    model = T.Transformer(cfg, seed=seed, device=DEVICE)
    sync()
    init_s = time.time() - t
    n_params = sum(p.numel() for p in model.parameters())
    ts = TokenStream(cfg.vocab, B, S, seed)
    mb0 = token_batch(ts.batch_at(0)[:B // M], DEVICE)
    kept, kept32 = [], []

    def loss_and_gnorm(m, keep):
        """The first microbatch's loss, f32 gradient norm and each leaf's
        gradient norm."""
        names, params = zip(*m.named_parameters())
        with kept_shares(keep):
            loss = T.loss_fn(m, mb0)[0]
        grads = torch.autograd.grad(loss, params)
        leaf = {k: float(g.float().norm()) for k, g in zip(names, grads)}
        del grads
        return float(loss.detach()), float(np.sqrt(sum(
            v * v for v in leaf.values()))), leaf

    loss16, gnorm16, leaf16 = loss_and_gnorm(model, kept)
    f32 = copy.deepcopy(model).float()
    f32.cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  act_dtype=torch.float32)
    loss32, gnorm32, leaf32 = loss_and_gnorm(f32, kept32)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    gap = abs(loss16 - loss32) / abs(loss32)
    ggap = abs(gnorm16 - gnorm32) / abs(gnorm32)
    leaf_gap = {k: leaf16[k] / leaf32[k] - 1 for k in leaf32}
    log(f"  lm train {cfg.name}: first microbatch's loss bf16 {loss16} "
        f"against f32 {loss32} (gap {gap}), gradient norm bf16 {gnorm16} "
        f"against f32 {gnorm32} (gap {ggap}; by leaf, bf16 / f32 - 1: "
        f"{json.dumps(leaf_gap)}), kept share per layer {kept} (f32 "
        f"{kept32})")

    # a slice of every weight matrix, to see the steps move it (not the
    # norm scales: at 1.0 a bf16 step is 2^-7, more than the steps move)
    before = {k: p.detach().reshape(-1)[:1 << 16].clone()
              for k, p in model.named_parameters()
              if p.ndim >= 2 and not k.split(".")[-1].startswith("ln")}
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(model)
    step = make_train_step(cfg, schedule=constant(LM_TRAIN_LR),
                           microbatches=M)
    step_ms, losses, gnorms = [], [], []
    for s in range(LM_TRAIN_STEPS):
        batch = token_batch(ts.batch_at(s), DEVICE)
        sync()
        t = time.time()
        m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        step_ms.append((time.time() - t) * 1e3)
        log(f"  lm train step {s}: {step_ms[-1]:.2f} ms, loss {losses[-1]}, "
            f"gnorm {gnorms[-1]}")
    batch = token_batch(ts.batch_at(LM_TRAIN_STEPS), DEVICE)
    by_name = {}
    wall, busy, idle, _rec, _exp = idle_share(
        lambda: step(model, opt, batch), by_name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launches()
    still = sorted(k for k, p in model.named_parameters() if k in before
                   and torch.equal(p.detach().reshape(-1)[:1 << 16],
                                   before[k]))
    del before
    warm = np.asarray(step_ms[1:])
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, params=n_params, init_s=init_s,
        batch=B, microbatches=M, seq=S, steps=LM_TRAIN_STEPS,
        step_first_ms=step_ms[0], step_warm_ms=step_ms[1:],
        step_p50_ms=float(np.percentile(warm, 50)),
        step_p99_ms=float(np.percentile(warm, 99)),
        tokens_per_s=float(B * S / np.percentile(warm, 50) * 1e3),
        peak_mem_gib=peak, free_gib=(torch.cuda.get_device_properties(
            0).total_memory / 2**30 - peak),
        profiled_step_ms=wall * 1e3, device_busy_ms=busy * 1e3,
        idle_share=idle, losses=losses, gnorms=gnorms,
        loss_bf16=loss16, loss_f32=loss32, loss_gap=gap,
        gnorm_bf16=gnorm16, gnorm_f32=gnorm32, gnorm_gap=ggap,
        gnorm_leaf_gap=leaf_gap, lr=LM_TRAIN_LR, kept_share=kept,
        kept_share_f32=kept32,
        top_kernels_ms={n: ms for n, (_c, ms) in top}, launches=counts)
    log("  lm train: " + json.dumps(out))
    del opt, model
    # torch.utils.checkpoint leaves reference cycles that hold the
    # parameters until a collection
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  lm train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB left "
        f"allocated")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"lm train: losses {losses}, gnorms {gnorms}")
    if not gap <= LM_LOSS_GAP:
        raise AssertionError(f"lm train: bf16 loss {loss16} differs from "
                             f"f32 {loss32} by {gap} (> {LM_LOSS_GAP})")
    off = {k: v for k, v in leaf_gap.items() if not abs(v) <= (
        LM_EMBED_GNORM_GAP if k == "embed" else LM_GNORM_GAP)}
    if off:
        raise AssertionError(f"lm train: bf16 gradient norms differ from "
                             f"f32 ones by {off} (> {LM_GNORM_GAP}, the "
                             f"embedding's > {LM_EMBED_GNORM_GAP})")
    if still:
        raise AssertionError(f"lm train: the steps left {still} unchanged")
    if counts["flash_attention"]:
        raise AssertionError(f"lm train: {counts['flash_attention']} flash "
                             f"launches, expected none")
    return counts


def lm_serve_phase(seed: int, arch: str = "gemma2-2b", layers=None,
                   prompt_len: int = SERVE_PROMPT) -> dict:
    """``arch`` at full width (depth ``layers``, else the config's; bf16
    parameters and activations, random parameters drawn on the card from
    ``seed``): 4 requests of ``prompt_len``-token prompts (TokenStream),
    prefill, then 32 greedy decode steps into a cache filled from the
    prefill's k/v; SERVE_ROUNDS rounds (1 cold), one profiled prefill and
    one profiled decode step.  A dense arch's first decode step's logits
    are held against a prefill of the prompt and that step's token, and
    every round emits the same tokens.  An MoE arch's decode is not held
    to a prefill: a prefill of S + 1 tokens has another capacity and sort
    order than a decode step, so its drops differ legitimately (``lm
    verify`` holds the card to the host); its rounds, the cold one too,
    emit the same tokens, and the share of assignments each layer keeps
    is reported.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    cfg = _lm_arch(arch).full_config
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S, n_dec = SERVE_BATCH, prompt_len, SERVE_DECODE
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

    err = scale = None
    if not cfg.is_moe:
        # decode against prefill at full depth: the first decode step (the
        # token at position S) against the last row of a prefill of S + 1
        # tokens; both bf16 on the card, with other matmul shapes (4 rows
        # against 4 x (S + 1)) and so other roundings through every layer
        ext = torch.cat([prompt,
                         torch.from_numpy(generated[:, :1]).to(DEVICE)], 1)
        (want, kv), n = counted(lambda: T.prefill(model, ext))
        per_prefill.append(n)
        del kv
        err = float((first.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        agree = float((first.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"  lm serve: decode at position {S} against prefill of "
            f"{S + 1}: max |err| {err} of max |logit| {scale}, argmax "
            f"agreement {agree}")
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

    kept_prefill, kept_step = [], []
    with kept_shares(kept_prefill):
        (wall, busy, idle, rec, exp), by_name = profiled(
            lambda: T.prefill(model, prompt), prefill_names, per_prefill)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    cache = T.make_cache(cfg, B, S + n_dec, device=DEVICE)
    with kept_shares(kept_step):
        (dwall, dbusy, didle, drec, dexp), dec_by = profiled(
            lambda: T.decode_step(model, cache, tok, S), step_names,
            per_step)
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
        kept_share_prefill=kept_prefill[-cfg.num_layers:] or None,
        kept_share_decode=kept_step[-cfg.num_layers:] or None,
        flash_per_prefill=per_prefill[0], flash_per_step=per_step[0],
        prefill_top_kernels_ms={n: ms for n, (_c, ms) in top},
        launches=totals)
    log("  lm serve: " + json.dumps(out))
    return totals


def graph_check(seed: int) -> int:
    """``--graph-check``: one ``torch.cuda.graph`` capture of a fused
    extend call (one level of a triangle plan over an R-MAT scale-16 edge
    projection, W = B' = 8192), of a merge-rank call and of a commit fold
    in each form (``in_ba`` and ``base``, committed regions of 32,768 and
    deltas of 2,048 over the same projection), replayed, against eager
    calls, bit for bit.  Prints one JSON line per kernel: captured
    and equal, or the runtime's refusal.  Returns 1 when a replay differs,
    else 0.  Runs in a process of its own, so that a refused capture leaves
    no state behind in the main run."""
    import torch
    from repro_torch.core import csr
    from repro_torch.data.synthetic import rmat_graph
    from repro_torch.kernels.extend import ops as eops
    from repro_torch.kernels.merge import fold as mfold
    from repro_torch.kernels.merge import ops as mops
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    edges = rmat_graph(16, 16, seed=seed)
    idx = csr.build_index(edges, (0,), 1, narrow=True, device=dev)
    part = csr.build_index(edges[rng.integers(0, edges.shape[0], 50_000)],
                           (0,), 1, narrow=True, device=dev)
    W = 8192
    pre = edges[rng.integers(0, edges.shape[0], W)]
    qks = [torch.from_numpy(pre[:, 1].copy()).to(dev),
           torch.from_numpy(pre[:, 0].copy()).to(dev)]
    wk = torch.zeros(W, dtype=torch.int32, device=dev)
    valid = torch.arange(W, device=dev) < 6000
    calls = {
        "fused_extend": lambda: eops.fused_extend(
            [(idx, part), (idx,)], [(part,), ()], qks, wk, valid, W),
        "rank_lt_le": lambda: mops.rank_lt_le(part.key, part.val, part.n,
                                              idx.key, idx.val),
    }
    cc, ub = 1 << 15, 1 << 11
    fresh = rng.integers(0, 1 << 16, (40_000, 2)).astype(np.int32)
    ci, cd = (csr.build_index(r, (0,), 1, capacity=cc, narrow=True,
                              device=dev)
              for r in (fresh[:cc - 2000], edges[:cc // 3]))
    ui, ud = (csr.build_index(r, (0,), 1, capacity=ub, narrow=True,
                              device=dev)
              for r in (fresh[cc:cc + ub // 2],
                        np.concatenate([edges[:ub // 4], fresh[:ub // 4]])))
    in_ba = mfold.base_bits(idx, ud)
    calls["commit_fold in_ba"] = lambda: mfold.commit_fold(
        ci, cd, ui, ud, in_ba, cins_cap=cc, cdel_cap=cc)
    calls["commit_fold base"] = lambda: mfold.commit_fold(
        ci, cd, ui, ud, base=idx, cins_cap=cc, cdel_cap=cc)
    rc = 0
    for name, fn in calls.items():
        want = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as asked
            fn()
        torch.cuda.current_stream().wait_stream(side)
        sync()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                got = fn()
        except RuntimeError as e:  # the runtime's refusal is the finding
            print(json.dumps({"graph": name, "captured": False,
                              "error": str(e)[:300]}), flush=True)
            continue
        graph.replay()
        sync()
        try:
            max_abs_err(got, want)
            equal = True
        except AssertionError:
            equal = False
            rc = 1
        print(json.dumps({"graph": name, "captured": True,
                          "replay_equal": equal}), flush=True)
    return rc


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


# ---------------------------------------------------------------------------
# phase 20: the dry run — every (arch x shape x production mesh) cell on
# meta tensors in a process beside the verify cells, the wcoj arch's smoke
# run on the card beside them, and two cells on the card at a cut size
# held to the dry run's own counts at the same shapes
# ---------------------------------------------------------------------------

DRYRUN_RECORDS = 88  # 44 cells x 2 meshes
# (label, module, arguments, what a passing run prints); the dry run sees
# no card (it allocates nothing), the wcoj smoke run is on the card
DRYRUN_CHILDREN = (
    ("dryrun", "repro_torch.launch.dryrun",
     ["--mesh", "both", "--out",
      os.path.join("build", "dryrun_torch.jsonl")], "done; 0 failures"),)
WCOJ_CHILDREN = (
    ("train wcoj-subgraph", "repro_torch.launch.train",
     ["--arch", "wcoj-subgraph"], "smoke {"),)
# the card cells' meta counts, a process of its own beside the verify
# cells (no card visible): ``chip_smoke.py --dryrun-meta``
DRY_META_CHILDREN = (
    ("dryrun meta", "chip_smoke", ["--dryrun-meta"], '{"dryrun_meta"'),)
DRY_ARCH = "gemma2-2b"
DRY_DEPTH = 2  # cut from 26
DRY_BATCH = {"train_4k": 4, "prefill_32k": 1}  # cut from 256 and 32
# the card's peak of bytes allocated beyond the arguments against the meta
# run's peak of live storage bytes: the caching allocator rounds every
# block up to 512 bytes (under 1 MiB over a step's live tensors), and
# cuBLAS and cuBLASLt take their workspaces through it at a stream's first
# matmul (tens of MiB); the meta run sees neither.  So the bar is 64 MiB
# plus 2 % of the meta peak, not equality
DRY_TEMP_TOL = (0.02, 64 << 20)


def start_dryrun(root: str) -> dict:
    """The dry-run and meta-count children: no card visible, one thread
    each (they run beside the build and the first phases).  Any still
    running when the script exits, as after a failed phase, is killed."""
    procs = start_children(root, DRYRUN_CHILDREN + DRY_META_CHILDREN,
                           CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")

    def stop():
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return procs


def finish_dryrun(root: str, procs: dict) -> dict:
    """Wait for the dry-run child and the wcoj train driver's (started
    beside the verify cells) and check them: the dry run wrote
    DRYRUN_RECORDS records, none an error, its skipped cells those of the
    registry's skip reasons (on both meshes); the wcoj smoke run counted
    (its own check: equal to Generic Join's) through the membership
    kernel.  Returns the wcoj child's launches."""
    from repro_torch.configs import get_arch, list_archs
    outs = {}
    secs = finish_children(procs, DRYRUN_CHILDREN + WCOJ_CHILDREN,
                           "dryrun", outs)
    path = os.path.join(root, DRYRUN_CHILDREN[0][2][-1])
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    want = sorted((a, s, m) for a in list_archs()
                  for s, c in get_arch(a).cells.items() if c.skip_reason
                  for m in ("16x16", "2x16x16"))
    skipped = sorted((r["arch"], r["shape"], r["mesh"]) for r in recs
                     if r["status"] == "skipped")
    log(f"  dryrun: {len(recs)} records {status}, skipped "
        f"{sorted({(a, s) for a, s, _ in skipped})}; child "
        f"{secs['dryrun']:.2f} s (no card visible)")
    wcoj_rows = [dict(shape=r["shape"], mesh=r["mesh"],
                      argument_bytes=r["per_device"]["argument_bytes"],
                      flops=r["flops_per_device"])
                 for r in recs if r["arch"] == "wcoj-subgraph"
                 and r["status"] == "ok"]
    log("  " + json.dumps({"dryrun_wcoj_per_device": wcoj_rows}))
    if len(recs) != DRYRUN_RECORDS or status.get("error") or \
            skipped != want:
        raise AssertionError(f"dryrun: {len(recs)} records {status}, "
                             f"skipped {skipped}, want {want}")
    line = [ln for ln in outs["train wcoj-subgraph"].splitlines()
            if ln.startswith("smoke {")][-1]
    smoke, launched = line[len("smoke "):].split(" launches ")
    smoke, launched = json.loads(smoke), json.loads(launched)
    log(f"  train wcoj-subgraph: count {smoke['count']} (Generic Join's), "
        f"{smoke['steps']} steps, {secs['train wcoj-subgraph']:.2f} s; "
        f"signed_member {launched['signed_member']}, fused_extend "
        f"{launched['fused_extend']} launches (the mesh's levels go "
        f"through its services)")
    if not launched["signed_member"] > 0:
        raise AssertionError(f"train wcoj-subgraph: no membership launch "
                             f"{launched}")
    return launched


def _dry_cells():
    """(name, shape, the cell's maker) of the card cells, and the cut
    config."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs import lm_family as LF
    cfg = dataclasses.replace(get_arch(DRY_ARCH).full_config,
                              num_layers=DRY_DEPTH)
    cells = []
    for name, batch in DRY_BATCH.items():
        shape = dict(LF.SHAPES[name], batch=batch)
        cells.append((name, shape, LF.CELL_OF[shape["kind"]]))
    return cfg, cells


def dryrun_meta_counts() -> dict:
    """The card cells' counts on meta (``dryrun.count``) and their
    argument bytes on one device, with the seconds each took."""
    from repro_torch.launch import dryrun
    cfg, cells = _dry_cells()
    one = {"data": 1, "model": 1}  # one device: every spec replicated
    out = {}
    for name, shape, make in cells:
        t = time.time()
        step, margs, axes, donate = make(cfg, shape)
        meta = dryrun.count(step, margs)
        meta["argument_bytes"] = dryrun.argument_bytes(margs, axes, donate,
                                                       one)[0]
        meta["seconds"] = time.time() - t
        out[name] = meta
    return out


def dryrun_card_phase(seed: int, procs: dict) -> dict:
    """gemma2-2b's train_4k and prefill_32k cells at depth DRY_DEPTH and
    the batches of DRY_BATCH, on meta (the dry run's counts) and on the
    card (random parameters from the seed): the train step runs no kernel
    and its FlopCounterMode total equals the meta count; the prefill
    launches the flash kernel once a layer, its outputs have the meta
    run's shapes and dtypes, and the kernel operations of its calls
    (``kernel_ops``, the bound column's count) equal the meta counter's;
    on both the card's allocator peak beyond the arguments is within
    DRY_TEMP_TOL of the meta peak, and the arguments' bytes equal the meta
    ones.  Also segment_sum's scratch size on the host against the
    library's.  The meta counts come from the ``--dryrun-meta`` child
    among ``procs`` (taken out of it).  Returns the flash launches of the
    prefill."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.segment_ops import ops as sops
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    outs = {}
    finish_children({"dryrun meta": procs.pop("dryrun meta")},
                    DRY_META_CHILDREN, "dryrun", outs)
    metas = json.loads([ln for ln in outs["dryrun meta"].splitlines()
                        if ln.startswith('{"dryrun_meta"')][-1])
    metas = metas["dryrun_meta"]
    lib = _build.lib("segment_sum")
    for E, D in ((163_840, 70), (524_288, 256), (0, 3), (1, 1), (33, 4),
                 (1000, 7)):
        if sops.scratch_words(E, D) != lib.repro_segment_sum_scratch(E, D):
            raise AssertionError(f"segment_sum scratch at E={E} D={D}: "
                                 f"{sops.scratch_words(E, D)} words, the "
                                 f"library's "
                                 f"{lib.repro_segment_sum_scratch(E, D)}")
    cfg, cells = _dry_cells()
    total = {}
    for name, shape, make in cells:
        meta = metas[name]
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        step, cargs, _, _ = make(cfg, shape, device=DEVICE, seed=seed)
        sync()
        base = torch.cuda.memory_allocated()
        calls = []
        inner = T.mha

        def mha(q, k, v, causal=True, window=0, softcap=0.0, q_offset=0):
            calls.append((tuple(q.shape), k.shape[1], causal, window,
                          q_offset))
            return inner(q, k, v, causal, window, softcap, q_offset)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        T.mha = mha
        try:
            t = time.time()
            card = dryrun.count(step, cargs)
            sync()
            card_s = time.time() - t
        finally:
            T.mha = inner
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated() - base
        kops = sum(fops.kernel_ops(*c) for c in calls)
        rtol, atol = DRY_TEMP_TOL
        row = dict(
            shape=name, depth=DRY_DEPTH, batch=shape["batch"],
            seq=shape["seq"],
            meta_flops=meta["flops"], card_torch_flops=card["torch_flops"],
            meta_kernel_ops=meta["kernel_ops"]["flash_attention"],
            card_kernel_ops=kops, flash_launches=counts["flash_attention"],
            meta_temp_bytes=meta["temp_bytes"], card_peak_bytes=peak,
            card_tracked_temp_bytes=card["temp_bytes"],
            temp_ratio=peak / max(meta["temp_bytes"], 1),
            meta_argument_bytes=meta["argument_bytes"],
            card_argument_bytes=base - before, outputs=meta["outputs"],
            meta_s=meta["seconds"], card_s=card_s)
        log("  " + json.dumps({"dryrun_card": row}))
        bad = []
        if card["torch_flops"] + kops != meta["flops"]:
            bad.append("FLOPs")
        if json.loads(json.dumps(card["outputs"])) != meta["outputs"]:
            bad.append(f"outputs {card['outputs']}")
        if kops != meta["kernel_ops"]["flash_attention"] or \
                counts["flash_attention"] != len(calls) or \
                len(calls) != (DRY_DEPTH if shape["kind"] == "prefill"
                               else 0):
            bad.append("flash calls")
        if abs(peak - meta["temp_bytes"]) > rtol * meta["temp_bytes"] + atol:
            bad.append("peak bytes")
        if abs((base - before) - meta["argument_bytes"]) > atol:
            bad.append("argument bytes")
        if bad:
            raise AssertionError(f"dryrun {name}: the card disagrees with "
                                 f"the meta count: {bad}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del step, cargs, card
        gc.collect()
        torch.cuda.empty_cache()
    return total


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
                    "16:triangle,diamond@4, 20:triangle@20 and "
                    "14:triangle,4-clique-tri@7")
    ap.add_argument("--verify", action="append", type=parse_cell,
                    help="a verify cell SCALE:query,query[@EPOCHS[/BATCH]] "
                    "(repeatable, 8 epochs unless given); default "
                    "9:triangle,diamond@5, 14:triangle@4, "
                    "9:triangle,4-clique,4-clique-tri@5 and "
                    "8:4-clique,5-clique,5-clique-quad@5/64")
    ap.add_argument("--update-batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify-only", action="store_true",
                    help="only run the --verify cells in this process and "
                    "print their launch counts (the main run starts one "
                    "such process per verify cell, all together)")
    ap.add_argument("--dryrun-meta", action="store_true",
                    help="only count the dry run phase's card cells on meta "
                    "tensors (no card needed) and print them as one JSON "
                    "line (the main run starts one such process beside "
                    "the verify cells)")
    ap.add_argument("--ranks-only", action="store_true",
                    help="only build the kernels and run phase 21, the mesh "
                    "across processes at size, each run alone (no result "
                    "line; ~5 min)")
    ap.add_argument("--graph-check", action="store_true",
                    help="only capture fused extend and merge ranks in a "
                    "CUDA graph and hold the replay to eager calls (the "
                    "kernels phase runs this in a process of its own)")
    args = ap.parse_args()
    # diamond's epochs at scale 16 take 9-25 s each on the host-bound
    # BiGJoin loop, so that cell runs 2 epochs, and serve 20 runs 8: with
    # the mesh stream the whole script must stay inside its time limit on
    # a slow host (PERF.md §4 lists every cut)
    cells = args.serve or [(16, ["triangle", "diamond"], 2, None),
                           (20, ["triangle"], 8, None),
                           (14, ["triangle", "4-clique-tri"], 7, None)]
    checks = args.verify or [
        (9, ["triangle", "diamond"], 5, None), (14, ["triangle"], 4, None),
        (9, ["triangle", "4-clique", "4-clique-tri"], 5, None),
        (8, ["4-clique", "5-clique", "5-clique-quad"], 5, 64)]

    import torch
    if args.dryrun_meta:
        print(json.dumps({"dryrun_meta": dryrun_meta_counts()}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.graph_check:
        return graph_check(args.seed)
    if args.verify_only:
        return verify_only(checks, args.update_batch, args.seed)
    if args.ranks_only:
        return ranks_only()
    # f32 matmuls in full f32 (the defaults, stated): the train phases
    # hold the card's steps to the host's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import VARIANTS, _build
    from repro_torch.data.synthetic import rmat_graph

    # the dry run's children need no card: they run beside the build and
    # the first phases
    root = os.path.dirname(os.path.abspath(__file__))
    dry = start_dryrun(root)
    # the graphs are made on the host beside the build (numpy frees the
    # GIL): the serve cells' and the mesh stream's
    scales = sorted({c[0] for c in cells} | {REAL_SCALE})
    makers = ThreadPoolExecutor(len(scales))
    made = {sc: makers.submit(rmat_graph, sc, 16, seed=args.seed)
            for sc in scales}

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

    # every session and training run below starts its kernel counts at 0
    # and reads them after; the table's launches sum them over these runs
    launches = {name: 0 for name in VARIANTS}
    # the phases that need no graph run while the graphs are made: the
    # training and LM checks and the dry run's card cells
    for label, run in (
            ("train driver", lambda: train_driver_phase(args.seed)),
            ("train archs", lambda: train_archs_phase(args.seed)),
            ("train recsys", lambda: train_recsys_phase(args.seed)),
            ("lm verify", lambda: lm_verify_phase(args.seed)),
            ("lm train verify", lambda: lm_train_verify_phase(args.seed)),
            ("lm train mixtral-8x7b", lambda: lm_train_phase(args.seed)),
            ("dryrun", lambda: dryrun_card_phase(args.seed, dry))):
        with phase(label):
            counts = run()
            for name in VARIANTS:
                launches[name] += counts.get(name, 0)
    gc.collect()
    torch.cuda.empty_cache()

    graphs = {}
    built = {}  # n-ary relation -> (graph, rows, seconds), see relation_rows
    with phase("graph"):
        for scale in scales:
            graphs[scale] = made[scale].result()
            log(f"  rmat scale {scale}: |E|={graphs[scale].shape[0]}")
        makers.shutdown()

    with phase("kernels"):
        top = max(c[0] for c in cells)
        table = kernel_phase(graphs[top], 1 << top, args.update_batch,
                             16 * args.update_batch, args.reps, args.seed)
    tri_edges = graphs.get(TRI_SCALE)
    if tri_edges is None:
        tri_edges = rmat_graph(TRI_SCALE, 16, seed=args.seed)

    with phase("verify"):
        # the kernel-coverage gate and the mesh's harnesses and drivers
        # run beside the cells, processes too, and this process enumerates
        # the composite rows' ``tri`` relation on the card meanwhile (its
        # seconds share the host with the cells)
        coverage = start_coverage()
        mesh_children = start_children(root, MESH_CHILDREN)
        parity = ThreadPoolExecutor(1)
        cards = torch.cuda.device_count()
        ranked = parity.submit(parity_runs, root, cards)
        dry.update(start_children(root, WCOJ_CHILDREN))
        counts = verify_cells(
            checks, args.update_batch, args.seed,
            meanwhile=lambda: relation_rows(tri_edges, "tri", built))
        finish_coverage(coverage)
        finish_children(mesh_children, MESH_CHILDREN, "mesh")
        parity.shutdown()
        for name, n in finish_ranks(ranked.result(), cards,
                                    timed=False).items():
            launches[name] += n
        wcoj = finish_dryrun(root, dry)
        for name in VARIANTS:
            launches[name] += counts[name] + wcoj[name]

    with phase("kernels composite"):
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
        log(f"  commit fold edge checks by grid size: "
            f"{ {g: len(v) for g, v in sorted(FOLD_GRIDS.items())} }")
        if 1 not in FOLD_GRIDS or max(FOLD_GRIDS) < 2:
            raise AssertionError(f"the commit fold edge checks reached grids "
                                 f"{sorted(FOLD_GRIDS)}, not one block and "
                                 f"more")
        # a CUDA graph over fused extend and merge ranks, in its own process
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--graph-check", "--seed", str(args.seed)],
                             capture_output=True, text=True, timeout=600)
        for ln in out.stdout.splitlines():
            log(f"  {ln}")
        if out.returncode != 0:
            raise AssertionError(f"CUDA graph check failed (rc "
                                 f"{out.returncode}): {out.stderr[-2000:]}")
        flash_rows(table, args.reps, args.seed)

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

    # transactions at the serve 20:triangle cell's size, the serving pool,
    # then the example twins, each in a process of its own
    with phase("txn"):
        top = graphs.get(20)
        if top is None:
            top = rmat_graph(20, 16, seed=args.seed)
        counts = txn_phase(top, 1 << 20, args.update_batch, args.seed, built,
                           graphs.get(REAL_SCALE))
        for name in VARIANTS:
            launches[name] += counts.get(name, 0)
    with phase("pool"):
        counts = pool_phase(args.update_batch, args.seed)
        for name in VARIANTS:
            launches[name] += counts.get(name, 0)
    with phase("examples"):
        examples_phase()
    with phase("mesh"):
        top = graphs.get(MESH_SCALE)
        if top is None:
            top = rmat_graph(MESH_SCALE, 16, seed=args.seed)
        counts = mesh_phase(top, args.seed)
        for name in VARIANTS:
            launches[name] += counts.get(name, 0)
    with phase("mesh stream"):
        top = graphs.get(REAL_SCALE)
        if top is None:
            top = rmat_graph(REAL_SCALE, 16, seed=args.seed)
        counts, _real = mesh_stream_phase(top, table, args.reps, args.seed)
        for name in VARIANTS:
            launches[name] += counts.get(name, 0)

    # the GNN training path at full width, segment_sum's kernel rows at the
    # trainer's shape; then the LM serving path
    for label, run in (
            ("train full", lambda: train_full_phase(table, args.reps,
                                                    args.seed)),
            ("lm serve gemma2-2b", lambda: lm_serve_phase(args.seed)),
            ("lm serve mixtral-8x7b", lambda: lm_serve_phase(
                args.seed, "mixtral-8x7b", LM_SERVE_MOE_LAYERS,
                LM_SERVE_MOE_PROMPT))):
        with phase(label):
            counts = run()
            for name in VARIANTS:
                launches[name] += counts.get(name, 0)

    rows = []
    for name in VARIANTS:
        r = table[name]
        src, replaces = SOURCES[kernel_of(name)]
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
