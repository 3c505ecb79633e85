"""The port's ``wcoj-subgraph`` arch (``configs/wcoj.py``) against the
JAX package's, on the CPU: the index shards of every cell leaf for leaf
at 256 and 512 workers, the analytic work per round, and the smoke run's
distributed count (one worker) against the JAX smoke run's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import wcoj as JW
from repro.core.plan import make_delta_plan as jmake_delta_plan
from repro.core.plan import make_plan as jmake_plan
from repro.core import query as JQ
from repro_torch.configs import wcoj as TW
from repro_torch.core import query as TQ
from repro_torch.core.plan import make_delta_plan, make_plan
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch.mesh import make_production_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(shape):
    if shape["kind"] == "join":
        return (make_plan(TQ.PAPER_QUERIES[shape["query"]]()),
                jmake_plan(JQ.PAPER_QUERIES[shape["query"]]()))
    return (make_delta_plan(TQ.delta_queries(
                TQ.PAPER_QUERIES[shape["query"]]())[0]),
            jmake_delta_plan(JQ.delta_queries(
                JQ.PAPER_QUERIES[shape["query"]]())[0]))


def _port_leaves(vidx):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
            for region in vidx.pos + vidx.neg
            for t in (region.key, region.val, region.n, region.lo)
            if t is not None]


@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("name", sorted(JW.SHAPES))
def test_abstract_indices_equal_jax(name, w):
    shape = JW.SHAPES[name]
    assert TW.SHAPES[name] == shape
    tplan, jplan = _plans(shape)
    got = TW._abstract_indices(tplan, shape["edges"], w,
                               shape.get("delta", 0))
    want = JW._abstract_indices(jplan, shape["edges"], w,
                                shape.get("delta", 0))
    assert sorted(got) == sorted(want)
    for index_id in want:
        jl = [(tuple(l.shape), str(l.dtype), "meta")
              for l in jax.tree.leaves(want[index_id])]
        assert _port_leaves(got[index_id]) == jl, index_id


@pytest.mark.parametrize("name", sorted(JW.SHAPES))
def test_model_flops_equal_jax(name):
    assert TW._model_flops(name) == JW._model_flops(name)
    # at the mesh's own worker count, 512 is the JAX package's
    assert TW._model_flops(name, 512) == JW._model_flops(name)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_cells_shard_one_worker_a_device(multi):
    """Every argument of a cell is ``[w, ...]`` and each device holds one
    worker's ``[1, ...]`` (the ``workers`` rule over every mesh axis)."""
    mesh = make_production_mesh(multi)
    w = int(np.prod(list(mesh.values())))
    for name, cell in TW.WCOJ.cells.items():
        _, args, axes, donate = cell.build(mesh)
        assert donate == ()
        leaves = [l for i in range(4) for l in shard_tree(axes[i], args[i],
                                                          mesh)]
        assert leaves and all(x.shape[0] == w and s[0] == 1
                              and tuple(s[1:]) == tuple(x.shape[1:])
                              for _, x, s in leaves), name


def test_smoke_run_equals_jax():
    got = TW.WCOJ.smoke_run(None, device="cpu")
    want = JW._smoke_run()
    assert got["count"] == want["count"] > 0
