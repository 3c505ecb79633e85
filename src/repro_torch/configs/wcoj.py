"""The paper's own workload as an architecture: distributed WCOJ subgraph
queries on the production mesh (every device one dataflow worker).

A cell is the per-worker join program (seed -> drain of the level steps
-> sum over the workers, ``core.distributed.build_per_worker``) with
hash-partitioned index shards ``[w, cap]`` as its arguments, each
worker's shard ``[1, cap]`` (the ``workers`` rule: every device a
worker).  ``*_delta`` cells take one dQ_i of Delta-BiGJoin: a
three-region multi-version index seeded by an update batch.  The
program's loop reads queue sizes on the host each step, so it does not
run on ``meta``: the dry run sums the arguments' shard bytes and reads
the work from :func:`_model_flops`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.core import query as Q
from repro_torch.core.bigjoin import BigJoinConfig
from repro_torch.core.csr import IndexData, round_capacity
from repro_torch.core.dataflow_index import VersionedIndex
from repro_torch.core.distributed import DistConfig, build_per_worker
from repro_torch.core.plan import make_delta_plan, make_plan
from repro_torch.core.query import delta_queries
from repro_torch.launch.mesh import WorkerMesh

SHAPES = {
    # IN = edge count; B' = per-worker proposal budget
    "triangle_static": dict(kind="join", query="triangle", edges=1 << 26,
                            batch=4096),
    "fourclique_static": dict(kind="join", query="4-clique", edges=1 << 24,
                              batch=4096),
    "triangle_delta_1m": dict(kind="delta", query="triangle",
                              edges=1 << 26, delta=1_000_000, batch=4096),
    "diamond_delta_1m": dict(kind="delta", query="diamond", edges=1 << 26,
                             delta=1_000_000, batch=4096),
}


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _abstract_indices(plan, edges: int, w: int, delta: int = 0):
    """Hash-partitioned index shards [w, cap] on ``meta``: the committed
    region at 1.3x an even share of the edges, each delta region at 2x
    an even share of the update batch, SEG-aligned as
    ``csr.build_index`` rounds."""
    cap = round_capacity(np.ceil(edges / w * 1.3))
    dcap = round_capacity(max(int(np.ceil(delta / w * 2.0)), 1))

    def region(c):
        return IndexData(_meta(w, c), _meta(w, c), _meta(w))

    out = {}
    for index_id, rel, key_pos, ext_pos, version in plan.index_ids():
        if version == "static":
            out[index_id] = VersionedIndex((region(cap),), ())
        elif version == "old":
            out[index_id] = VersionedIndex(
                (region(cap), region(dcap)), (region(dcap),))
        else:  # new
            out[index_id] = VersionedIndex(
                (region(cap), region(dcap), region(dcap)),
                (region(dcap), region(dcap)))
    return out


def _parts(shape: Dict, w: int):
    """(plan, config, abstract index shards, seeds a worker) of a cell on
    ``w`` workers."""
    q = Q.PAPER_QUERIES[shape["query"]]()
    if shape["kind"] == "join":
        plan = make_plan(q)
        seed_total = shape["edges"]
    else:
        plan = make_delta_plan(delta_queries(q)[0])
        seed_total = shape["delta"]
    B = shape["batch"]
    dcfg = DistConfig(BigJoinConfig(batch=B, mode="count"), w,
                      route_capacity=max(4 * B // w, 16), aggregate=True)
    indices = _abstract_indices(plan, shape["edges"], w,
                                shape.get("delta", 0))
    return plan, dcfg, indices, int(np.ceil(seed_total / w))


def _build_cell(shape: Dict):
    def build(mesh):
        w = int(np.prod(list(mesh.values())))
        plan, dcfg, indices, S = _parts(shape, w)
        # signed seed weights: all ones for static joins, ±1 for dR seeds
        args = (indices, _meta(w, S, 2), _meta(w), _meta(w, S))
        axes = (("workers",),) * 4
        return build_per_worker(plan, dcfg, mesh=WorkerMesh(w, "meta")), \
            args, axes, ()
    return build


def step_exchange_bytes(shape_name: str, w: int) -> int:
    """The bytes each device sends in one step of a cell on ``w`` devices,
    every device a worker and a rank of its own: the
    ``exchange.EXCHANGE_BYTES`` count of a step at the plan's deepest
    level (the one the drain runs most, every binding's services;
    ``core.distributed.step_exchange_bytes``), from the route buffers'
    capacities at the cell's shapes."""
    from repro_torch.core.distributed import step_exchange_bytes as step
    plan, dcfg, indices, _ = _parts(SHAPES[shape_name], w)
    return step(plan, dcfg, indices, len(plan.levels) - 1, ranks=w)


def _smoke_run(_cfg=None, device=None):
    """Reduced config: the distributed join of the triangle query over an
    R-MAT scale-9 graph on a one-worker mesh on ``device`` (``None``: the
    card), held to serial Generic Join's count."""
    from repro_torch.core.distributed import distributed_join
    from repro_torch.core.generic_join import generic_join
    from repro_torch.data.synthetic import rmat_graph
    from repro_torch.launch.mesh import make_host_mesh
    e = rmat_graph(9, 4, seed=3)
    q = Q.triangle()
    plan = make_plan(q)
    mesh = make_host_mesh(1, device)
    cfg = DistConfig(BigJoinConfig(batch=512, mode="count"), 1,
                     route_capacity=512)
    res = distributed_join(plan, {Q.EDGE: e}, mesh=mesh, cfg=cfg)
    _, ref = generic_join(q, {Q.EDGE: e}, plan=plan)
    if res.count != ref:
        raise AssertionError(f"distributed join counted {res.count}, "
                             f"Generic Join {ref}")
    return {"count": float(res.count), "steps": float(res.steps)}


def _model_flops(shape_name: str, w: int = 512) -> float:
    """Useful work PER ROUND of the dataflow: w*B' proposals, each probed
    against ~n_atoms binary-search indices of depth log2(IN/w) (the JAX
    package's count, at its 512 workers unless ``w`` is given)."""
    shape = SHAPES[shape_name]
    q = Q.PAPER_QUERIES[shape["query"]]()
    B = float(shape["batch"])
    depth = np.log2(max(shape["edges"] / float(w), 2.0))
    return float(w) * B * q.num_atoms * 8.0 * depth


WCOJ = ArchSpec(
    "wcoj-subgraph", "wcoj",
    "the paper's contribution: BiGJoin/Delta-BiGJoin distributed WCOJ "
    "dataflow, every chip a worker",
    None, None,
    {name: Cell(name, shape["kind"], _build_cell(shape))
     for name, shape in SHAPES.items()},
    _smoke_run, _model_flops)
