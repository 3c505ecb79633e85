#!/usr/bin/env python3
"""In-turn A/B timing of fused extend and merge ranks of checkouts of this
repository, on one card.

    python3 chip_ab.py TREE ...

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
the CUDA activities one call records.  Prints nvidia-smi's name and power
limit, then one JSON line per measurement.  Needs one CUDA device; run
from the repository root.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOWS = (1024, 2048, 4096, 8192)


def worker(tree: str) -> None:
    os.environ["REPRO_TORCH_BUILD"] = os.path.join(tree, "build")
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"repro_torch came from {_build.__file__}")
    sys.path.insert(1, HERE)
    import chip_smoke as cs  # the helpers of this checkout
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
    for label, fn, want, reps, knames in cases:
        got = fn()
        cs.sync()
        cs.max_abs_err(got, want)
        by = {}
        cs.idle_share(fn, by_name=by)
        print(json.dumps(dict(
            tree=tree, case=label, ms=cs.cuda_ms(fn, reps),
            host_us=cs.host_us(fn, reps),
            device_ms=cs.device_ms(fn, reps, label, names=knames),
            records_per_call={n[:48]: c for n, (c, _ms) in by.items()})),
            flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        worker(os.path.abspath(args[1]))
        return 0
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
                        "--worker", os.path.abspath(tree)], check=True,
                       timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
