#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order, each printed with its result and seconds:

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — compile the four CUDA kernels from ``src/repro_torch/csrc``;
3. kernels  — every kernel against its plain PyTorch version on the card at
              the main path's shapes (int32 and int64 keys), exact equality,
              with the kernel's, the plain version's and one library call's
              time and the least time the card could take (``bound_ms``);
4. verify   — a GraphSession over dirty update epochs, one cell per
              (scale, queries): each epoch's signed delta equal to the numpy
              oracle (full recomputation), compaction included;
5. serve    — the same session at realistic graph sizes, one cell per
              (scale, queries): warm per-epoch latency, peak device memory
              and each kernel's launch count (every kernel must launch).

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


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the scalar rate."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    o = ops / SCALAR_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def depth(cap: int) -> int:
    return max(int(np.ceil(np.log2(max(cap, 2)))), 1)


def entry_bytes(idx) -> int:
    return idx.key.element_size() + 4


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


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output; raises on any
    difference in dtype, shape or bits."""
    import torch
    err = 0
    for g, w in zip(got, want):
        if hasattr(g, "key"):  # IndexData
            g, w = (g.key, g.val, g.n), (w.key, w.val, w.n)
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

    def record(name, err, ms, plain_ms, bytes_moved, ops, library_ms,
               shape, main):
        """One variant of a kernel; the table keeps the times of the
        variant the main path runs most (``main``), and the largest error
        over all variants."""
        b_ms, b_by = bound(bytes_moved, ops)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, shape=shape)
        log(f"  {name} [{shape}] ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) library_ms="
            f"{'null' if library_ms is None else f'{library_ms:.4f}'}"
            f" max_abs_err={err}")
        entry = results.setdefault(name, dict(max_abs_err=0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(row)

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
        pms = cuda_ms(lambda: iref.signed_member_ref(mregs, mnegs, qk, qv),
                      max(reps // 10, 2))
        words = packed_words(regs[0])
        qwords = (qk.to(torch.int64) << 32 | qv.to(torch.int64)) \
            if narrow else qk
        lms = cuda_ms(lambda: torch.searchsorted(words, qwords), reps)
        nbytes = B * (kb + 4) + 2 * 4 * B + sum(
            search_bytes(r, B) for r in mregs + mnegs)
        ops = B * sum(depth(max(int(r.n), 2)) for r in mregs + mnegs)
        record("signed_member", err, ms, pms, nbytes, ops, lms,
               f"{label} B={B} regions={len(mregs)}+{len(mnegs)} "
               f"cap={regs[0].capacity}", main=not narrow)

        # -- merge ranks (compaction: every base entry against cdel) -------
        a = negs[0]
        q_key, q_val = base.key, base.val
        got = mops.rank_lt_le(a.key, a.val, a.n, q_key, q_val)
        want = mref.rank_ref(a.key, a.val, a.n, q_key, q_val)
        sync()
        err = max_abs_err(got, want)
        rreps = max(reps // 10, 3)
        ms = cuda_ms(lambda: mops.rank_lt_le(a.key, a.val, a.n, q_key,
                                             q_val), rreps)
        pms = cuda_ms(lambda: mref.rank_ref(a.key, a.val, a.n, q_key, q_val),
                      2)
        awords = packed_words(a)
        bq = (q_key.to(torch.int64) << 32 | q_val.to(torch.int64)) \
            if narrow else q_key
        lms = cuda_ms(lambda: torch.searchsorted(awords, bq), rreps)
        Bq = q_key.shape[0]
        nbytes = Bq * (kb + 4) + 2 * 4 * Bq + search_bytes(a, 2 * Bq)
        ops = 2 * Bq * depth(max(int(a.n), 2))
        record("rank_lt_le", err, ms, pms, nbytes, ops, lms,
               f"{label} B={Bq} cap={a.capacity} n={int(a.n)}",
               main=narrow)

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
        pms = cuda_ms(fold_p, max(reps // 10, 2))
        # the fold reads the live entries of its four regions and of in_ba,
        # and writes both outputs whole (their padding included)
        live = [int(r.n) for r in (ci, cd, ui, ud)]
        nbytes = sum(n * entry_bytes(r) + 4 for n, r in
                     zip(live, (ci, cd, ui, ud))) + 4 * live[3] \
            + 2 * cc * (kb + 4) + 8
        ops = sum(live) * 3 * depth(cc)
        record("commit_fold", err, ms, pms, nbytes, ops, None,
               f"{label} caps={ci.capacity}/{cd.capacity}/{ui.capacity}/"
               f"{ud.capacity} out={cc}", main=narrow)

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
        record("fused_extend", err, ms, pms, nbytes, ops, None,
               f"{label} W={W} B'={Bp} bindings=2 regions={nreg}",
               main=narrow)
    return results


# ---------------------------------------------------------------------------
# phases 4/5: the streaming session
# ---------------------------------------------------------------------------

def run_stream(session, handles, stream, live, epochs, check=None,
               label=None):
    """Drive ``epochs`` update epochs; returns (live, per-epoch seconds).
    With a ``label`` every epoch's time and delta sizes are logged."""
    secs = []
    for epoch in range(epochs):
        upd, w = stream.batch_at(epoch, live)
        sync()
        t = time.time()
        res = session.update(upd, w)
        sync()
        secs.append(time.time() - t)
        if label:
            rows = {n: 0 if d.tuples is None else int(d.tuples.shape[0])
                    for n, d in res.deltas.items()}
            log(f"  {label} epoch {epoch}: {secs[-1] * 1e3:.1f} ms, "
                f"delta rows {rows}")
        new = res.advance(live)
        if check is not None:
            check(epoch, res, live, new)
        live = new
    return live, secs


def verify_phase(scale: int, names, epochs: int, update_batch: int,
                 seed: int):
    from repro_torch import kernels
    from repro_torch.api import GraphSession
    from repro_torch.core.delta import _unique_rows, canon_arrays, rows_isin
    from repro_torch.core.generic_join import generic_join
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph

    edges = rmat_graph(scale, 16, seed=seed)
    ratio = 0.5 * update_batch / edges.shape[0]
    session = GraphSession(edges, device=DEVICE, update_batch=update_batch,
                           compact_ratio=ratio)
    handles = {n: session.register(n) for n in names}

    def full(q, e):
        return _unique_rows(generic_join(q, {"edge": e})[0])

    prev = {n: full(h.query, edges) for n, h in handles.items()}

    def check(epoch, res, live, new):
        for n, h in handles.items():
            cur = full(h.query, new)
            added = cur[~rows_isin(cur, prev[n])]
            removed = prev[n][~rows_isin(prev[n], cur)]
            t = np.concatenate([added, removed])
            w = np.concatenate([np.ones(added.shape[0], np.int32),
                                -np.ones(removed.shape[0], np.int32)])
            m = h.query.num_attrs
            want = canon_arrays(t, w, m)
            d = res.deltas[n]
            got = canon_arrays(d.tuples, d.weights, m)
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                raise AssertionError(f"verify: epoch {epoch} {n} delta "
                                     f"differs from the oracle")
            prev[n] = cur
            log(f"  verify epoch {epoch} {n}: {want[0].shape[0]} delta rows "
                f"== oracle")

    kernels.reset_launches()
    stream = EdgeUpdateStream(1 << scale, update_batch, seed=seed + 1)
    live, _ = run_stream(session, handles, stream, edges, epochs, check)
    counts = kernels.launches()
    if not np.array_equal(session.edges, live):
        raise AssertionError("verify: live edge set differs")
    if session.stats.compactions == 0:
        raise AssertionError("verify: no compaction ran")
    log(f"  verify: |E|={edges.shape[0]} epochs={epochs} "
        f"compactions={session.stats.compactions} launches={counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"verify: a kernel never launched: {counts}")


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
    live, secs = run_stream(session, handles, stream, edges, epochs,
                            label=f"serve {edges.shape[0]} edges")
    counts = kernels.launches()
    n_live = session.num_edges
    if n_live != live.shape[0]:
        raise AssertionError(f"serve: live edges {n_live} != host-tracked "
                             f"{live.shape[0]}")
    if min(counts.values()) == 0:
        raise AssertionError(f"serve: a kernel never launched: {counts}")
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
        delta_rows={n: int(h.last_delta.tuples.shape[0]
                           if h.last_delta.tuples is not None else 0)
                    for n, h in handles.items()})
    log("  serve: " + json.dumps(out))
    return out


SOURCES = {
    "signed_member": ("src/repro_torch/csrc/intersect.cu",
                      "src/repro/kernels/intersect/intersect.py:235"),
    "fused_extend": ("src/repro_torch/csrc/extend.cu",
                     "src/repro/kernels/extend/extend.py:274"),
    "rank_lt_le": ("src/repro_torch/csrc/merge_rank.cu",
                   "src/repro/kernels/merge/merge.py:144"),
    "commit_fold": ("src/repro_torch/csrc/fold.cu",
                    "src/repro/kernels/merge/fold.py:244"),
}


def parse_cell(text: str):
    """``SCALE:query,query[@EPOCHS]`` -> (scale, [queries], epochs or
    None for the phase's default)."""
    cell, _, epochs = text.partition("@")
    scale, queries = cell.split(":")
    return int(scale), queries.split(","), int(epochs) if epochs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", action="append", type=parse_cell,
                    help="a serve cell SCALE:query,query[@EPOCHS] "
                    "(repeatable, 20 epochs unless given); default "
                    "16:triangle,diamond@10 and 20:triangle@20")
    ap.add_argument("--verify", action="append", type=parse_cell,
                    help="a verify cell SCALE:query,query[@EPOCHS] "
                    "(repeatable, 8 epochs unless given); default "
                    "9:triangle,diamond@8 and 14:triangle@8")
    ap.add_argument("--update-batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # diamond's epochs at scale 16 take seconds each on the host-bound
    # BiGJoin loop, so that cell runs fewer of them to keep the whole
    # script near half its time limit
    cells = args.serve or [(16, ["triangle", "diamond"], 10),
                           (20, ["triangle"], 20)]
    checks = args.verify or [(9, ["triangle", "diamond"], 8),
                             (14, ["triangle"], 8)]

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import KERNELS, _build
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
            regs = [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
            log(f"  {name}: " + " | ".join(regs[:8]))
        log(f"  built {sorted(logs)} in {time.time() - t:.2f} s")

    graphs = {}
    with phase("graph"):
        for scale in sorted({c[0] for c in cells}):
            graphs[scale] = rmat_graph(scale, 16, seed=args.seed)
            log(f"  rmat scale {scale}: |E|={graphs[scale].shape[0]}")

    with phase("kernels"):
        top = max(graphs)
        table = kernel_phase(graphs[top], 1 << top, args.update_batch,
                             16 * args.update_batch, args.reps, args.seed)

    for scale, queries, epochs in checks:
        with phase(f"verify {scale}:{','.join(queries)}"):
            verify_phase(scale, queries, epochs or 8, args.update_batch,
                         args.seed)

    launches = {name: 0 for name in KERNELS}
    for scale, queries, epochs in cells:
        with phase(f"serve {scale}:{','.join(queries)}"):
            edges = graphs[scale]
            ratio = 8 * args.update_batch / edges.shape[0]
            serve = serve_phase(edges, 1 << scale, queries, epochs or 20,
                                args.update_batch, ratio, args.seed)
            for name in KERNELS:
                launches[name] += serve["launches"][name]

    rows = []
    for name in KERNELS:
        r = table[name]
        src, replaces = SOURCES[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=int(launches[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
