"""Dry run: every (arch x shape x production mesh) cell on ``meta``
tensors, nothing allocated and nothing launched.

The JAX package lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's memory and cost analyses.  The port gets the
same answers by PyTorch's own means:

  1. the cell builds its step and arguments on ``meta`` (shapes and
     dtypes, no memory; ``configs.base.Cell``);
  2. each argument's shard on one device follows from its logical axes
     over the mesh (``distributed.sharding.shard_tree``; a spec XLA would
     refuse raises, and a failure IS a system bug);
  3. the step runs on ``meta`` under ``FlopCounterMode`` and a dispatch
     mode that tracks the bytes of the storages its ops allocate: the
     kernel wrappers' meta branches add their kernels' operations
     (``kernels.META_OPS``) and scratch;
  4. layer-stacked cells run at two depths and extrapolate to the full
     one, once for both meshes (the meta run does not depend on the mesh);
  5. the roofline terms follow from the card's peaks
     (``launch.mesh``).

Fields of a record: ``per_device.argument_bytes`` (the exact sum of the
arguments' shard bytes; an int, such as the optimizer's step, counts as
the int32 scalar the JAX programs carry), ``alias_bytes`` (the donated
arguments' shard bytes), ``temp_bytes`` (the peak of live bytes the step
allocates beyond its arguments, outputs included, over ``chips``:
``temp_basis``), ``flops_per_device`` with ``flops_basis`` ("counted":
``FlopCounterMode``'s total plus the kernels' operations over ``chips``;
"analytic": the wcoj cells, whose loop reads queue sizes on the host and
so cannot run on ``meta``, and whose integer searches no counter counts,
record the per-round work of ``configs.wcoj._model_flops``),
``kernel_ops_per_device``, ``probe`` and ``roofline`` (``compute_s`` =
FLOPs / the bf16 peak, ``memory_s`` = 2 x (argument + temp bytes) / the
memory rate; for the wcoj cells ``collective_s``, the bytes a device
sends in one step, ``configs.wcoj.step_exchange_bytes``, over its
NVLink and NDR links, ``launch.mesh.link_seconds``, and ``bound_s`` the
largest of the three).  Every number is a model estimate, not a
measurement.

Dropped from the JAX dry run, with the reason: ``lower_s`` and
``compile_s`` (nothing is compiled); ``hlo_bytes_per_device`` and
``memory_s_nofusion`` (XLA's unfused operand count has no counterpart);
the HLO collective parsing (``parse_collectives``, ``_wire_factor``,
``_DTYPE_BYTES``, ``_cost_dict``) with ``collectives``: there is no HLO
to read, so ``collective_s`` of the LM, GNN and recsys cells is null
(their collectives are the sharding rules' and no counter models them
yet; ``collective_basis`` says so); the ``XLA_FLAGS`` device-count
override; ``output_bytes`` (null): XLA chose the output layout.

Run: ``python -m repro_torch.launch.dryrun --mesh both`` (one JSON line
a cell to ``--out``, default ``build/dryrun_torch.jsonl``; exit 1 if any
cell fails).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels

ANALYTIC_KINDS = ("join", "delta")  # the wcoj cells
ESTIMATE = "model estimate over meta tensors; nothing allocated or run"


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes of storages that ops allocate while the mode
    is on, each counted until its last tensor dies.  An output whose
    storage is one of its op's inputs' (a view, an in-place op) is no
    allocation; storages that existed before the mode are never
    counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}

    def _free(self, key: int, nbytes: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(t.untyped_storage())
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _r, key=key, n=n: self._free(key, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def count(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` under the counters: FLOPs of PyTorch's ops
    (``FlopCounterMode``), the kernels' operations (their meta branches;
    on the card the kernels launch and add nothing), the peak of live
    bytes allocated beyond the arguments, and the shape and dtype of each
    output tensor.  Works on any device."""
    kernels.reset_meta_ops()
    live = LiveBytes()
    flops = FlopCounterMode(display=False)
    with flops, live:
        out = step(*args)
        shapes = [(tuple(t.shape), str(t.dtype)) for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
        del out
    kops = dict(kernels.META_OPS)
    return {"torch_flops": int(flops.get_total_flops()),
            "kernel_ops": kops,
            "flops": int(flops.get_total_flops()) + sum(kops.values()),
            "temp_bytes": int(live.peak), "outputs": shapes}


def _leaf_bytes(x, shard) -> int:
    size = 4 if isinstance(x, int) else x.element_size()
    return int(np.prod(shard, dtype=np.int64)) * size


def argument_bytes(args, axes, donate, mesh) -> tuple:
    """(argument bytes, donated bytes) of one device's shards."""
    from repro_torch.distributed.sharding import shard_tree
    total = alias = 0
    for i, (x, ax) in enumerate(zip(args, axes)):
        b = sum(_leaf_bytes(leaf, shard)
                for _, leaf, shard in shard_tree(ax, x, mesh))
        total += b
        alias += b if i in donate else 0
    return total, alias


def _extrap(p0: float, p1: float, d1: int, d2: int, full: int,
            scale: float) -> float:
    # slope clamped >= 0, as the JAX dry run clamps it
    slope = max(p1 - p0, 0.0)
    return max(p0 + slope * (full - d1) / max(d2 - d1, 1), p1) * scale


def cell_counts(cell, mesh, no_probe: bool) -> Dict[str, Any]:
    """The whole cell's counts: probed at two depths and extrapolated, or
    (no probe) run at full depth."""
    if cell.probe is None or no_probe:
        step, args = cell.build(mesh)[:2]
        return count(step, args)
    d1, d2 = cell.probe_depths
    pts = [count(*cell.probe(mesh, d)[:2]) for d in (d1, d2)]

    def ex(key, kernel=None):
        a, b = ((p[key] if kernel is None else p[key][kernel])
                for p in pts)
        return _extrap(float(a), float(b), d1, d2, cell.full_depth,
                       cell.probe_scale)
    kops = {k: ex("kernel_ops", k) for k in pts[0]["kernel_ops"]}
    return {"torch_flops": ex("torch_flops"), "kernel_ops": kops,
            "flops": ex("torch_flops") + sum(kops.values()),
            "temp_bytes": ex("temp_bytes"),
            "probe": {"depths": [d1, d2],
                      "points": [[p["flops"], p["temp_bytes"]]
                                 for p in pts],
                      "full_depth": cell.full_depth}}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, no_probe: bool = False,
             cache: Optional[dict] = None) -> Dict[str, Any]:
    """One cell's record.  ``cache`` keeps the meta counts of an (arch,
    shape) for the other mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import (BF16_OPS_PER_S, HBM_BYTES_PER_S,
                                         link_seconds, make_production_mesh)

    spec = get_arch(arch_id)
    cell = spec.cells[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": cell.kind, "source": ESTIMATE,
    }
    if cell.skip_reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip_reason
        return rec

    mesh = make_production_mesh(multi_pod)
    chips = int(np.prod(list(mesh.values())))
    t0 = time.time()
    step, args, axes, donate = cell.build(mesh)
    arg_b, alias_b = argument_bytes(args, axes, donate, mesh)
    if cell.kind in ANALYTIC_KINDS:
        model_flops = float(spec.model_flops(shape_name, chips))
        c = {"flops": model_flops, "kernel_ops": {}, "temp_bytes": None}
        basis = "analytic"
    else:
        model_flops = float(spec.model_flops(shape_name))
        key = (arch_id, shape_name, no_probe)
        c = cache.get(key) if cache is not None else None
        if c is None:
            c = cell_counts(cell, mesh, no_probe)
            if cache is not None:
                cache[key] = c
        basis = "counted"
    temp = None if c["temp_bytes"] is None else c["temp_bytes"] / chips
    flops_dev = c["flops"] / chips
    rec.update({
        "status": "ok", "chips": chips, "seconds": time.time() - t0,
        "per_device": {
            "argument_bytes": arg_b, "alias_bytes": alias_b,
            "temp_bytes": temp,
            "temp_basis": "global peak / chips" if temp is not None else
            "not counted: the program's loop reads sizes on the host",
            "output_bytes": None,
        },
        "flops_per_device": flops_dev, "flops_basis": basis,
        "kernel_ops_per_device": {k: v / chips
                                  for k, v in c["kernel_ops"].items()},
    })
    if "probe" in c:
        rec["probe"] = c["probe"]
    compute_s = flops_dev / BF16_OPS_PER_S
    memory_s = 2.0 * (arg_b + (temp or 0.0)) / HBM_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s}
    if cell.kind in ANALYTIC_KINDS:
        from repro_torch.configs.wcoj import step_exchange_bytes
        sent = step_exchange_bytes(shape_name, chips)
        collective_s = terms["collective"] = link_seconds(sent, chips)
        basis = ("the bytes a device sends in one step (every device a "
                 "worker and a rank), over NVLink in its node and NDR "
                 "between nodes")
    else:
        sent = collective_s = None
        basis = ("not modelled: one process makes no collective, and no "
                 "counter models the sharding rules' collectives yet")
    dominant = max(terms, key=terms.get)
    rec["roofline"] = {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "collective_bytes_per_device": sent,
        "collective_basis": basis, "dominant": dominant,
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / max(flops_dev * chips, 1.0),
        "bound_s": max(terms.values()),
    }
    if verbose:
        print(f"[{rec['mesh']}] {arch_id}/{shape_name}: args "
              f"{arg_b / 2**30:.2f}GiB temp {(temp or 0) / 2**30:.2f}GiB "
              f"compute {compute_s * 1e3:.2f}ms mem {memory_s * 1e3:.2f}ms"
              f" -> {dominant} ({rec['seconds']:.1f} s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "dryrun_torch.jsonl"))
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="run each cell at its full depth on meta instead "
                    "of extrapolating from two probe depths")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, list_archs
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = 0
    cache: dict = {}
    with open(args.out, "a" if args.append else "w") as f:
        for arch_id in archs:
            spec = get_arch(arch_id)
            shapes = (list(spec.cells) if args.shape == "all"
                      else args.shape.split(","))
            for shape in shapes:
                if shape not in spec.cells:
                    continue
                for multi in meshes:
                    try:
                        rec = run_cell(arch_id, shape, multi,
                                       no_probe=args.no_probe, cache=cache)
                    except Exception as e:  # a failure IS a system bug
                        rec = {"arch": arch_id, "shape": shape,
                               "mesh": "2x16x16" if multi else "16x16",
                               "status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                        traceback.print_exc()
                        failures += 1
                        print(f"FAILED {arch_id}/{shape}", flush=True)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(f"done; {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
