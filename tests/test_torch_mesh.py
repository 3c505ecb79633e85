"""The static mesh of the port (``core.distributed``, ``core.balance``, the
sharded indices) against the JAX package's, on the CPU.

The JAX side runs once, in one subprocess with four host devices (the
JAX package's own pattern, ``tests/test_distributed_join.py``): it makes
every case's graph from a numpy seed, runs ``distributed_join`` and writes
one ``.npz`` of the inputs and results.  The port runs each case on the
same relations with the workers as a leading tensor axis, and every field
must agree bit for bit: count, proposals, intersections, steps, max and
mean load, and the collected tuples and weights of each worker in order.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

QUAD = "5-clique-quad(a,b,c,d,e) := quad(a,b,c,d), quad(a,b,c,e), e(d,e)"

# name: (query, workers, nv, ne, skew, batch, route_capacity, aggregate,
#        balance, relation)
CASES = {
    "triangle-w4": ("triangle", 4, 60, 500, False, 256, 64, True, False,
                    "edge"),
    "4-clique-skew": ("4-clique", 4, 70, 700, True, 256, 64, True, False,
                      "edge"),
    "diamond-deferral": ("diamond", 4, 60, 400, False, 256, 16, True,
                         False, "edge"),
    "triangle-no-aggregate": ("triangle", 4, 60, 400, False, 256, 64,
                              False, False, "edge"),
    "triangle-balance": ("triangle", 4, 120, 3000, True, 256, 64, True,
                         True, "edge"),
    "4-clique-balance": ("4-clique", 4, 70, 700, True, 256, 64, True, True,
                         "edge"),
    "triangle-w1": ("triangle", 1, 60, 500, False, 256, 64, True, False,
                    "edge"),
    "triangle-w3": ("triangle", 3, 60, 500, False, 256, 64, True, False,
                    "edge"),
    # the static 4-clique-tri plan keys on at most two columns (one int64
    # word); see test_composite_keys_match_the_oracle for (hi, lo) keys
    "4-clique-tri": ("4-clique-tri", 4, 40, 400, False, 256, 64, True,
                     False, "tri"),
    # a sparse graph whose seed windows are mostly rows without work: the
    # JAX Balance loses part of a chunk there (ROADMAP Queue 3), so this
    # case is held to the oracle (test_balance_keeps_every_chunk)
    "triangle-balance-sparse": ("triangle", 4, 1000, 1500, "core", 32, 64,
                                True, True, "edge"),
}
SPARSE = "triangle-balance-sparse"


# The JAX side: every case in one process, so that JAX starts once.  It
# records each worker's output rows (``out_n``) by wrapping the program
# ``distributed_join`` builds.
_JAX_RUNNER = r"""
import json, sys
import numpy as np
from repro.core import distributed as D
from repro.core import query as Q
from repro.core.bigjoin import BigJoinConfig
from repro.core.generic_join import generic_join
from repro.core.plan import make_plan

cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
ns = []
_build = D.build_distributed_program
def _recording(*a, **k):
    run = _build(*a, **k)
    def call(*args):
        out = run(*args)
        ns.append(np.asarray(out[9]))
        return out
    return call
D.build_distributed_program = _recording

res = {}
for name, (qn, w, nv, ne, skew, batch, rc, agg, bal, rel) in cases.items():
    rng = np.random.default_rng(0)
    if skew == "core":  # 60 vertices with out-edges, most heads sinks
        rng = np.random.default_rng(4)
        cores = rng.choice(nv, 60, replace=False)
        u = cores[rng.integers(0, 60, ne)]
        v = np.where(rng.random(ne) < 0.15, cores[rng.integers(0, 60, ne)],
                     rng.integers(0, nv, ne))
    elif skew:
        u = (rng.zipf(1.4, ne) % nv).astype(np.int64)
        v = rng.integers(0, nv, ne)
    else:
        u = rng.integers(0, nv, ne)
        v = rng.integers(0, nv, ne)
    keep = u != v
    e = np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32), axis=0)
    rels = {Q.EDGE: e}
    if rel == "tri":
        tri, _ = generic_join(Q.triangle(), rels)
        rels = {"tri": np.asarray(tri, np.int32)}
    plan = make_plan(Q.query_by_name(qn))
    cfg = D.DistConfig(
        BigJoinConfig(batch=batch, mode="collect", out_capacity=1 << 14,
                      use_kernel=False), w, route_capacity=rc,
        aggregate=agg, balance=bal)
    r = D.distributed_join(plan, rels, cfg=cfg)
    for k, a in rels.items():
        res[f"{name}/rel/{k}"] = a
    res[f"{name}/scalars"] = np.array(
        [r.count, r.proposals, r.intersections, r.steps, r.max_load,
         r.mean_load], np.float64)
    res[f"{name}/tuples"] = r.tuples
    res[f"{name}/weights"] = r.weights
    res[f"{name}/ns"] = ns.pop()
np.savez(out_path, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "jax_mesh.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    run = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, json.dumps(CASES), str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


def _port_run(name, relations):
    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import DistConfig, distributed_join
    from repro_torch.core.plan import make_plan
    qn, w, _, _, _, batch, rc, agg, bal, _ = CASES[name]
    plan = make_plan(Q.query_by_name(qn))
    cfg = DistConfig(BigJoinConfig(batch=batch, mode="collect",
                                   out_capacity=1 << 14), w,
                     route_capacity=rc, aggregate=agg, balance=bal)
    return plan, distributed_join(plan, relations, cfg=cfg, device="cpu")


@pytest.mark.parametrize("name", [n for n in CASES if n != SPARSE])
def test_distributed_join_matches_jax(name, jax_results):
    from repro_torch.core.generic_join import generic_join
    pre = f"{name}/rel/"
    rels = {k[len(pre):]: v for k, v in jax_results.items()
            if k.startswith(pre)}
    plan, got = _port_run(name, rels)
    want = jax_results[f"{name}/scalars"]
    assert [got.count, got.proposals, got.intersections, got.steps,
            got.max_load, got.mean_load] == list(want), name
    ns = jax_results[f"{name}/ns"]
    np.testing.assert_array_equal(got.worker_rows, ns)
    np.testing.assert_array_equal(got.tuples, jax_results[f"{name}/tuples"])
    np.testing.assert_array_equal(got.weights,
                                  jax_results[f"{name}/weights"])
    assert got.tuples.dtype == np.int32
    # and the answer is the oracle's
    assert got.count == generic_join(plan.query, rels)[1]
    if name == "diamond-deferral":
        assert got.steps > 5  # the deferral retried many rounds
    if name.endswith("-w1"):
        assert got.max_load == got.mean_load


def test_balance_keeps_every_chunk(jax_results):
    """Balance deals each worker's window in w chunks of equal work; a
    chunk covers at most B'/w + 2 rows WITH work, but rows without work
    (no extension) can lie between them.  The JAX package walks every row
    from a chunk's first and drops what lies past B'/w + 2 of them
    (reference ``core/balance.py:136-144``): on this sparse graph it
    counts 231 triangles of 233.  The port walks the rows with work, so
    it counts the oracle's, and where no chunk spans that far (every
    other case here) it sends the same pieces in the same order."""
    from repro_torch.core.generic_join import generic_join
    pre = f"{SPARSE}/rel/"
    rels = {k[len(pre):]: v for k, v in jax_results.items()
            if k.startswith(pre)}
    plan, got = _port_run(SPARSE, rels)
    ref, cnt = generic_join(plan.query, rels)
    assert got.count == cnt == 233
    np.testing.assert_array_equal(np.unique(got.tuples, axis=0),
                                  np.unique(np.asarray(ref), axis=0))
    assert int(jax_results[f"{SPARSE}/scalars"][0]) == 231  # the quirk


@pytest.mark.parametrize("edges", [
    [[0, 1], [0, 2], [1, 2], [2, 3], [1, 3]],  # 5 seeds: 3 pad rows > 2
    [[0, 1], [1, 2], [0, 2]], [[0, 1]], []])
def test_fewer_seeds_than_workers_squared(edges):
    """Seeds dealt in blocks of ceil(n/w): with n < w² the padding can
    exceed a block (5 seeds, w = 4), and no padding row may count as a
    seed (the JAX package's dealing counts 4 triangles here where there
    are 2, ROADMAP Queue 3)."""
    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import DistConfig, distributed_join
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.plan import make_plan
    e = np.asarray(edges, np.int32).reshape(-1, 2)
    cfg = DistConfig(BigJoinConfig(batch=64, mode="collect",
                                   out_capacity=256), 4, route_capacity=64)
    got = distributed_join(make_plan(Q.triangle()), {"edge": e}, cfg=cfg,
                           device="cpu")
    ref, cnt = generic_join(Q.triangle(), {"edge": e})
    assert got.count == cnt == got.tuples.shape[0]
    np.testing.assert_array_equal(np.unique(got.tuples, axis=0).reshape(
        -1, 3), np.unique(np.asarray(ref).reshape(-1, 3), axis=0))


@pytest.mark.parametrize("balance", [False, True])
def test_composite_keys_match_the_oracle(balance):
    """5-clique-quad over ``quad`` keys three of its levels' columns: the
    composite (hi, lo) pair through every service (the JAX package's
    static mesh raises on such a plan, ``qks[bi][r]`` indexing a key
    pair, so this case is held to the oracle and the single-device
    engine)."""
    from repro_torch.api.dsl import parse_pattern
    from repro_torch.core import bigjoin as tbj
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import (DistConfig, distributed_join,
                                              partition_indices)
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.plan import make_plan
    from repro_torch.core import query as Q
    from repro_torch.data.synthetic import uniform_graph
    e = uniform_graph(30, 420, seed=3)
    quad, _ = generic_join(Q.query_by_name("4-clique"), {"edge": e})
    rels = {"edge": e, "quad": np.asarray(quad, np.int32)}
    plan = make_plan(parse_pattern(QUAD))
    assert any(vi.pos[0].lo is not None for vi in
               partition_indices(plan, rels, 4, device="cpu").values())
    cfg = DistConfig(BigJoinConfig(batch=256, mode="collect",
                                   out_capacity=1 << 14), 4,
                     route_capacity=32, balance=balance)
    got = distributed_join(plan, rels, cfg=cfg, device="cpu")
    ref, cnt = generic_join(plan.query, rels)
    assert got.count == cnt > 0
    np.testing.assert_array_equal(np.unique(got.tuples, axis=0),
                                  np.unique(ref, axis=0))
    local = tbj.run_bigjoin(plan, tbj.build_indices(plan, rels,
                                                    device="cpu"),
                            tbj.seed_tuples_for(plan, rels),
                            cfg=BigJoinConfig(batch=256, mode="count"))
    assert local.count == got.count


KEYS = np.concatenate([np.arange(1000, dtype=np.int64) * 2654435761,
                       np.array([0, 1, 2**31 - 1, 2**62 + 7, 2**63 - 1,
                                 -1, -2**63], np.int64)])


@pytest.mark.parametrize("w", [1, 7, 16, 512])
def test_owner_hash_matches_jax(w):
    import jax.numpy as jnp
    from repro.core import csr as jcsr
    from repro.core import distributed as jdist
    from repro_torch.core import csr as tcsr
    from repro_torch.core import distributed as tdist
    want = np.asarray(jdist.owner_of(jnp.asarray(KEYS), w))
    np.testing.assert_array_equal(tdist.owner_of_np(KEYS, w), want)
    np.testing.assert_array_equal(
        tdist.owner_of(torch.from_numpy(KEYS), w).numpy(), want)
    np.testing.assert_array_equal(tcsr.shard_of(KEYS, w),
                                  jcsr.shard_of(KEYS, w))
    lo = KEYS[::-1].copy()
    np.testing.assert_array_equal(tcsr.combine_key(KEYS, lo),
                                  jcsr.combine_key(KEYS, lo))
    np.testing.assert_array_equal(
        tcsr.combine_key(torch.from_numpy(KEYS), torch.from_numpy(lo))
        .numpy(), jcsr.combine_key(KEYS, lo))
    want2 = np.asarray(jdist.owner_of((jnp.asarray(KEYS), jnp.asarray(lo)),
                                      w))
    np.testing.assert_array_equal(
        tdist.owner_of((torch.from_numpy(KEYS), torch.from_numpy(lo)), w)
        .numpy(), want2)
    np.testing.assert_array_equal(tdist.owner_of_np((KEYS, lo), w), want2)


@pytest.mark.parametrize("arity,key_pos,ext_pos", [
    (2, (0,), 1), (2, (1,), 0), (3, (0, 1), 2), (3, (0, 2), 1),
    (3, (0, 1, 2), 0), (4, (0, 1, 2), 3), (4, (0, 1, 2, 3), 0)])
@pytest.mark.parametrize("w", [1, 3, 4])
def test_build_sharded_index_matches_jax(arity, key_pos, ext_pos, w):
    from repro.core import csr as jcsr
    from repro_torch.core import csr as tcsr
    from repro_torch.core.dataflow_index import VersionedIndex
    rng = np.random.default_rng(arity * 10 + w)
    rows = rng.integers(0, 50, (300, arity)).astype(np.int32)
    for kw in ({}, {"capacity": 700}, {"narrow": False}):
        j = jcsr.build_sharded_index(rows, key_pos, ext_pos, w, **kw)
        t = tcsr.build_sharded_index(rows, key_pos, ext_pos, w,
                                     device="cpu", **kw)
        for f in ("key", "val", "n", "lo"):
            jv, tv = getattr(j, f), getattr(t, f)
            assert (jv is None) == (tv is None), f
            if jv is None:
                continue
            jv = np.asarray(jv)
            assert tv.numpy().dtype == jv.dtype, f
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=f)
        vi = VersionedIndex((t,), ())
        assert vi.live_entries() == int(np.asarray(j.n).sum())
        single = tcsr.build_index(rows, key_pos, ext_pos, device="cpu")
        assert vi.live_entries() == int(single.n)  # each entry owned once
        for i in range(w):
            s = vi.worker_shard(i).pos[0]
            np.testing.assert_array_equal(s.key.numpy(),
                                          np.asarray(j.key)[i])
            assert int(s.n) == int(np.asarray(j.n)[i])


def test_dedup_requests_matches_jax():
    import jax.numpy as jnp
    from repro.core.distributed import dedup_requests as jdedup
    from repro_torch.core.distributed import dedup_requests as tdedup
    key = np.asarray([5, 3, 5, 5, 9, 3, 7], np.int64)
    valid = np.asarray([1, 1, 1, 1, 1, 1, 0], bool)
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 3, 64).astype(np.int64)
    lo = rng.integers(0, 3, 64).astype(np.int64)
    v2 = rng.random(64) < 0.8
    for k, v in ((key, valid), ((hi, lo), v2), (hi.astype(np.int32), v2)):
        jk = tuple(map(jnp.asarray, k)) if isinstance(k, tuple) \
            else jnp.asarray(k)
        rep, is_rep = jdedup(jk, jnp.asarray(v))
        tk = tuple(torch.from_numpy(x)[None] for x in k) \
            if isinstance(k, tuple) else torch.from_numpy(k)[None]
        trep, tis = tdedup(tk, torch.from_numpy(v)[None])
        np.testing.assert_array_equal(trep[0].numpy(), np.asarray(rep))
        np.testing.assert_array_equal(tis[0].numpy(), np.asarray(is_rep))
    assert int(tis.sum()) > 0


def test_entry_points_need_a_device():
    from repro_torch.core import query as Q
    from repro_torch.core.distributed import distributed_join
    from repro_torch.core.plan import make_plan
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    assert make_host_mesh(4, "cpu") == WorkerMesh(4, "cpu")
    assert hash(make_host_mesh(2, "cpu")) == hash(WorkerMesh(2, "cpu"))
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    plan = make_plan(Q.triangle())
    e = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed_join(plan, {"edge": e})
    assert distributed_join(plan, {"edge": e}, device="cpu").count == 1


def test_dist_check_cli():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core._dist_check", "--device",
         "cpu", "--workers", "4", "--query", "triangle", "--ne", "400",
         "--balance"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["dist_count"] == rec["oracle_count"] and rec["tuples_exact"]
    assert rec["workers"] == 4
