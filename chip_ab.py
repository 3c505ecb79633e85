#!/usr/bin/env python3
"""In-turn A/B timing of session kernels of checkouts of this repository,
on one card.

    python3 chip_ab.py [--fold | --serve] TREE ...

Each TREE is a checkout of the repository (for a parent commit:
``git archive <commit> | tar -x -C build/parent``).  Each runs in a process
of its own, in the order given, so name trees twice to take turns
(parent, change, change, parent): the process builds the tree's
fused-extend and merge-rank libraries into TREE/build and times, with
``chip_smoke.py``'s helpers, fused extend over the R-MAT scale-20 edge
projections (two bindings, 5 + 3 regions, int32 keys) at the window sizes
the sessions run, W = B' = 1024, 2048, 4096 and 8192 (the first W rows of
row 3's window; 8192 is row 3 itself), and for a one-launch fused extend
its phases apart (row 3 with B' = 0: phases 1 and 2 alone; and with a
one-row window: phase 1 trivial, every slot expanding row 0), then merge
ranks of the 2^24-capacity base against cdel (row 4), each held to its
plain version first: CUDA-event ms, profiler device ms, ``host_us``, and
the CUDA activities one call records.

With ``--fold`` it times the commit fold instead: row 5 (int32
projections of the R-MAT scale-20 edges, committed regions of 32,768 and
deltas of 2,048, the ``in_ba`` form), row 5c (the same over a live set of
4,506,715 random 3-column rows, the size of the scale-14 triangles, which
``chip_smoke.py`` enumerates and this script does not), and on both
inputs the store's whole commit of one relation, ``delta._commit_fold``
(the probe of base and the fold: in a tree whose fold probes base itself
one launch, in its parent a merge-rank launch, a compare and the fold),
and that commit again with deltas (uins and udel) of 8,192 and 32,768
entries, the sizes a relation's deltas reach, each held to its plain
version first; device ms there sum every activity a call records.

With ``--serve`` it runs ``chip_smoke.py``'s serve 16:triangle,diamond
cell (a GraphSession over the R-MAT scale-16 edges, triangle and diamond
standing, 6 epochs of 2048 dirty updates) and its serve 20:triangle cell
(the scale-20 edges, 20 epochs) and reports each one's warm epoch p50 and
p99: a whole session's latency, compared in turns.

Prints nvidia-smi's name and power limit, then one JSON line per
measurement.  Needs one CUDA device; run from the repository root.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOWS = (1024, 2048, 4096, 8192)


def worker(tree: str, mode: str) -> None:
    os.environ["REPRO_TORCH_BUILD"] = os.path.join(tree, "build")
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"repro_torch came from {_build.__file__}")
    sys.path.insert(1, HERE)
    {"--fold": fold_cases, "--serve": serve_cases}.get(
        mode, extend_rank_cases)(tree)


def measure(tree, cases) -> None:
    """Each case ``(label, fn, want, reps, kernel names or None)``: held
    to its plain outputs, then timed; names None sums every activity."""
    import chip_smoke as cs  # the helpers of this checkout
    for label, fn, want, reps, knames in cases:
        got = fn()
        cs.sync()
        cs.max_abs_err(got, want)
        by = {}
        cs.idle_share(fn, by_name=by)
        dms = cs.device_ms(fn, reps, label, names=knames) if knames else \
            cs.library_device_ms(fn, reps, label)
        print(json.dumps(dict(
            tree=tree, case=label, ms=cs.cuda_ms(fn, reps),
            host_us=cs.host_us(fn, reps), device_ms=dms,
            records_per_call={n[:48]: c for n, (c, _ms) in by.items()})),
            flush=True)


def fold_cases(tree: str) -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import csr, delta
    from repro_torch.core.delta import _packed_index
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.merge import fold as mfold

    _build.build(["fold", "merge_rank"], force=True)
    dev = torch.device("cuda")
    seed, nv, ub, committed = 0, 1 << 20, 2048, 16 * 2048
    cc = csr.pow2_capacity(committed)
    edges = rmat_graph(20, 16, seed=seed)
    rng = np.random.default_rng(seed)
    upd, w = EdgeUpdateStream(nv, ub, seed=seed).batch_at(0, edges)
    ins = upd[w > 0]
    ins = ins[ins[:, 0] != ins[:, 1]]
    dels = upd[w < 0][: ub // 4]
    fresh = rng.integers(0, nv, (committed, 2)).astype(np.int32)
    fresh = fresh[fresh[:, 0] != fresh[:, 1]]
    gone = edges[rng.integers(0, edges.shape[0], committed // 3)]

    def proj(rows, cap):
        return csr.build_index(rows, (0,), 1, capacity=cap, narrow=True,
                               device=dev)

    tri = cs.random_relation(4_506_715, 3, 1 << 14, seed)

    def live(rows, cap=None):
        return _packed_index(rows, dev, 3, capacity=cap)

    def pick(rows, n):
        return rows[rng.integers(0, rows.shape[0], n)]

    inputs = {
        "5": (proj(edges, csr.pow2_capacity(edges.shape[0])),
              proj(fresh, cc), proj(gone, cc), proj(ins, ub),
              proj(dels, ub)),
        "5c": (live(tri), live(rng.integers(0, 1 << 14, (committed, 3))
                               .astype(np.int32), cc),
               live(pick(tri, committed // 3), cc),
               live(rng.integers(0, 1 << 14, (ub, 3)).astype(np.int32), ub),
               live(pick(tri, ub // 4), ub)),
    }
    five = ("fold_masks", "scan_tiles", "scan_tile_sums", "scan_apply",
            "fold_scatter")  # the first port's kernels
    names = five if "fold_masks" in open(os.path.join(
        tree, "src/repro_torch/csrc/fold.cu")).read() else ("fold_kernel",)
    cases = []
    for row, (base, ci, cd, ui, ud) in inputs.items():
        lt, le = csr.index_ranks(base, csr._qcols_of(ud), ud.val,
                                 plain=True)
        in_ba = (le > lt).to(torch.int32)
        want = mfold._commit_fold_ref(ci, cd, ui, ud, in_ba, cc, cc)
        cases += [
            (f"commit_fold row {row} (in_ba)",
             lambda ci=ci, cd=cd, ui=ui, ud=ud, in_ba=in_ba:
             mfold.commit_fold(ci, cd, ui, ud, in_ba, cins_cap=cc,
                               cdel_cap=cc), want, 50, names),
            (f"delta._commit_fold row {row} (probe of base and fold)",
             lambda base=base, ci=ci, cd=cd, ui=ui, ud=ud:
             delta._commit_fold(base, ci, cd, ui, ud, cins_cap=cc,
                                cdel_cap=cc), want, 50, None)]
    # the same commits with larger deltas: uins fresh rows, udel half rows
    # of base and a quarter random ones
    for u in (8192, 32768):
        for row, (base, ci, cd, _ui, _ud) in inputs.items():
            src, make, top, ar = (edges, proj, nv, 2) if row == "5" else \
                (tri, live, 1 << 14, 3)
            ui = make(np.unique(rng.integers(0, top, (3 * u // 4, ar))
                                .astype(np.int32), axis=0), u)
            ud = make(np.unique(np.concatenate([
                pick(src, u // 2), rng.integers(0, top, (u // 4, ar))
                .astype(np.int32)]), axis=0), u)
            lt, le = csr.index_ranks(base, csr._qcols_of(ud), ud.val,
                                     plain=True)
            ci_cap = csr.pow2_capacity(int(ci.n) + int(ui.n))
            cd_cap = csr.pow2_capacity(int(cd.n) + int(ud.n))
            want = mfold._commit_fold_ref(ci, cd, ui, ud,
                                          (le > lt).to(torch.int32), ci_cap,
                                          cd_cap)
            cases.append((
                f"delta._commit_fold row {row} deltas {u}",
                lambda base=base, ci=ci, cd=cd, ui=ui, ud=ud, a=ci_cap,
                b=cd_cap: delta._commit_fold(base, ci, cd, ui, ud,
                                             cins_cap=a, cdel_cap=b),
                want, 50, None))
    measure(tree, cases)


def serve_cases(tree: str) -> None:
    import numpy as np
    import chip_smoke as cs
    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph
    from repro_torch.kernels import _build

    _build.build(["intersect", "extend", "merge_rank", "fold"], force=True)
    ub, seed = 2048, 0
    for scale, queries, epochs in ((16, ("triangle", "diamond"), 6),
                                   (20, ("triangle",), 20)):
        edges = rmat_graph(scale, 16, seed=seed)
        session = GraphSession(edges, device="cuda", update_batch=ub,
                               compact_ratio=8 * ub / edges.shape[0])
        for name in queries:
            session.register(name)
        stream = EdgeUpdateStream(1 << scale, ub, seed=seed + 2)
        _live, secs = cs.run_stream(session, stream, edges, epochs, tree)
        warm = np.asarray(secs[1:]) * 1e3
        print(json.dumps(dict(
            tree=tree, case=f"serve {scale}:{','.join(queries)}",
            first_ms=secs[0] * 1e3,
            warm_p50_ms=float(np.percentile(warm, 50)),
            warm_p99_ms=float(np.percentile(warm, 99)),
            warm_ms=warm.tolist())), flush=True)
        del session


def extend_rank_cases(tree: str) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.core import csr
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph
    from repro_torch.kernels.extend import ops as eops, ref as eref
    from repro_torch.kernels.merge import ops as mops, ref as mref

    _build.build(["extend", "merge_rank"], force=True)
    dev = torch.device("cuda")
    seed, nv, ub, committed = 0, 1 << 20, 2048, 16 * 2048
    # the inputs of chip_smoke.kernel_phase's int32 rows
    edges = rmat_graph(20, 16, seed=seed)
    rng = np.random.default_rng(seed)
    upd, w = EdgeUpdateStream(nv, ub, seed=seed).batch_at(0, edges)
    ins = upd[w > 0]
    ins = ins[ins[:, 0] != ins[:, 1]]
    dels = upd[w < 0][: ub // 4]
    fresh = rng.integers(0, nv, (committed, 2)).astype(np.int32)
    fresh = fresh[fresh[:, 0] != fresh[:, 1]]
    gone = edges[rng.integers(0, edges.shape[0], committed // 3)]
    cc = csr.pow2_capacity(committed)

    def proj(rows, cap):
        return csr.build_index(rows, (0,), 1, capacity=cap, narrow=True,
                               device=dev)

    regs = [proj(edges, csr.pow2_capacity(edges.shape[0])),
            proj(fresh, cc), proj(ins, ub)]
    negs = [proj(gone, cc), proj(dels, ub)]
    pos, neg = [tuple(regs), tuple(regs[:2])], [tuple(negs), tuple(negs[:1])]
    seeds = np.concatenate([ins, dels])
    nseed = min(seeds.shape[0], max(WINDOWS))
    window = np.zeros((max(WINDOWS), 2), np.int32)
    window[:nseed] = seeds[:nseed]
    a, base = negs[0], regs[0]
    src = open(os.path.join(tree, "src/repro_torch/csrc/extend.cu")).read()
    names = ("extend_kernel",) if "extend_propose" not in src else (
        "extend_count", "extend_budget", "extend_propose")

    def ext_call(W, Bp):
        qks = [torch.from_numpy(window[:W, 1].copy()).to(dev),
               torch.from_numpy(window[:W, 0].copy()).to(dev)]
        wk = torch.zeros(W, dtype=torch.int32, device=dev)
        valid = torch.arange(W, device=dev) < nseed
        return (lambda: eops.fused_extend(pos, neg, qks, wk, valid, Bp),
                eref.fused_extend_ref(pos, neg, qks, wk, valid, Bp))

    cases = [(f"fused_extend W=B'={W}", *ext_call(W, W), 50, names)
             for W in WINDOWS]
    if names == ("extend_kernel",):  # the phases apart
        W = max(WINDOWS)
        cases += [(f"fused_extend W={W} B'=0", *ext_call(W, 0), 50, names),
                  (f"fused_extend W=1 B'={W}", *ext_call(1, W), 50, names)]
    cases.append(("rank_lt_le row 4",
                  lambda: mops.rank_lt_le(a.key, a.val, a.n, base.key,
                                          base.val),
                  mref.rank_ref(a.key, a.val, a.n, base.key, base.val), 5,
                  ("rank_kernel",)))
    measure(tree, cases)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        worker(os.path.abspath(args[1]), (args[2:] or [""])[0])
        return 0
    mode = args[0] if args[:1] in (["--fold"], ["--serve"]) else ""
    args = args[1:] if mode else args
    if not args or any(t.startswith("-") for t in args):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in args:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", os.path.abspath(tree)]
                       + ([mode] if mode else []), check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
