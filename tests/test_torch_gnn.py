"""The port's GNN training path on the CPU against the JAX package: the
data pipeline (uniform graph, degree relabel, motif features through
BiGJoin, the neighbor sampler) exactly; the four archs' forward and three
AdamW training steps within a tolerance; the driver's checkpoint restart.

Tolerances: forward outputs rtol 1e-5 and atol 1e-5 times the largest
|output| (at least 1): f32 matmuls and sums run in another order (the JAX
Pallas segment sum adds by one-hot matmul), and EGNN's and GraphCast's
outputs reach 59 and 224 and cancel down to entries near 1, where f32
rounding alone leaves either package 3-6e-5 from a float64 forward;
after three training steps losses rtol 1e-4 and parameters and AdamW
moments atol 1e-5: the first steps of Adam are sign-like (m / sqrt(v) is
about ±1 for every nonzero gradient), so a gradient entry that rounds to
the other side of zero moves its parameter by up to 2 lr.  Schedules and
two bare AdamW updates rtol 1e-6 (f32 arithmetic, the global norm summed
in another order)."""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.configs.gnn_family import make_train_step as j_make_train_step
from repro.core.csr import Graph as JGraph
from repro.data import NeighborSampler as JSampler
from repro.data import rmat_graph as j_rmat_graph
from repro.data import uniform_graph as j_uniform_graph
from repro.data.motifs import motif_features as j_motif_features
from repro.models import gnn as JG
from repro.optim import adamw_init as j_adamw_init
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_family import make_train_step, smoke_batch
from repro_torch.core.csr import Graph
from repro_torch.data.graph_sampler import NeighborSampler
from repro_torch.data.motifs import motif_features
from repro_torch.data.synthetic import uniform_graph
from repro_torch.launch import train as ttrain
from repro_torch.models import gnn as TG
from repro_torch.optim import adamw_init

ARCHS = ["egnn", "gatedgcn", "gat-cora", "graphcast", "graph_reg"]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nv,ne,seed", [(300, 2400, 0), (1000, 5000, 3)])
def test_uniform_graph_and_degree_relabel_equal(nv, ne, seed):
    edges = uniform_graph(nv, ne, seed=seed)
    want = j_uniform_graph(nv, ne, seed=seed)
    assert edges.dtype == want.dtype
    np.testing.assert_array_equal(edges, want)
    got = Graph.from_edges(edges, nv).degree_relabel()
    ref = JGraph.from_edges(want, nv).degree_relabel()
    assert got.num_vertices == ref.num_vertices
    assert got.num_edges == ref.num_edges
    np.testing.assert_array_equal(got.edges, ref.edges)
    und = Graph.from_edges(edges, nv).undirected()
    np.testing.assert_array_equal(
        und.edges, JGraph.from_edges(want, nv).undirected().edges)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_blocks_equal(seed):
    edges = j_uniform_graph(400, 3200, seed=seed)
    seeds = np.random.default_rng(seed).choice(400, 64, replace=False)
    got = NeighborSampler(edges, 400).sample_blocks(seeds, [5, 5], seed=seed)
    want = JSampler(edges, 400).sample_blocks(seeds, [5, 5], seed=seed)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("graph", ["uniform300", "rmat8"])
def test_motif_features_equal(graph):
    if graph == "uniform300":
        edges, nv = j_uniform_graph(300, 2400, seed=0), 300
    else:
        edges, nv = j_rmat_graph(8, 16, seed=0), 256
    got = motif_features(Graph.from_edges(edges, nv), device="cpu")
    want = j_motif_features(JGraph.from_edges(edges, nv))
    assert got.dtype == want.dtype and got.shape == (nv, 1)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _configs(arch):
    """(port cfg, JAX cfg, port batch, JAX batch) of the smoke run."""
    arch_id = "gatedgcn" if arch == "graph_reg" else arch
    base = get_arch(arch_id).smoke_config
    jbase = j_get_arch(arch_id).smoke_config
    if arch == "graph_reg":  # the molecule convention: graph_id pooling
        base = dataclasses.replace(base, task="graph_reg", d_out=1)
    cfg, batch = smoke_batch(base, "cpu")
    jcfg = dataclasses.replace(jbase, d_in=cfg.d_in, d_out=cfg.d_out,
                               task=cfg.task)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    return cfg, jcfg, batch, jbatch


def _dotted(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jax-segsum", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, use_kernel):
    cfg, jcfg, batch, jbatch = _configs(arch)
    jparams = JG.init(jax.random.PRNGKey(0), jcfg)
    model = convert.gnn_params(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    want = np.asarray(JG.forward(
        jparams, jbatch, dataclasses.replace(jcfg, use_kernel=use_kernel)))
    got = model(batch).detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    cfg, jcfg, batch, jbatch = _configs(arch)
    jparams = JG.init(jax.random.PRNGKey(0), jcfg)
    model = convert.gnn_params(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    opt = adamw_init(model)
    jopt = j_adamw_init(jparams)
    jstep = jax.jit(j_make_train_step(jcfg))
    step = make_train_step(cfg)
    for i in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        m = step(model, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert opt.step == int(jopt.step) == 3
    for name, tree in (("params", None), ("mu", opt.mu), ("nu", opt.nu)):
        want = _dotted({"params": jparams, "mu": jopt.mu,
                        "nu": jopt.nu}[name])
        got = {k: p.detach().numpy() for k, p in
               (model.named_parameters() if tree is None
                else tree.items())}
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """The host's multithreaded f32 kernels vary in the last bits between
    two identical runs; on one thread a run repeats bit for bit, so a
    restart can be held to an uninterrupted run exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(ckpt, steps):
    return types.SimpleNamespace(nodes=300, seed=0, steps=steps,
                                 ckpt_dir=str(ckpt), ckpt_every=10,
                                 log_every=5)


def _ckpt_params(path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(path))
    steps = mgr.all_steps()
    from repro_torch.checkpoint import load_raw
    leaves, manifest = load_raw(os.path.join(
        str(path), f"ckpt_{steps[-1]:010d}"))
    return {r["name"]: a for r, a in zip(manifest["leaves"], leaves)}, \
        steps[-1]


def test_driver_resumes_from_checkpoint(tmp_path, capsys, one_thread):
    spec = get_arch("gatedgcn")
    a, b = tmp_path / "a", tmp_path / "b"
    ttrain.train_gnn(spec, _args(a, 10), device="cpu")
    loss = ttrain.train_gnn(spec, _args(a, 20), device="cpu")
    assert "resumed from step 10" in capsys.readouterr().out
    ttrain.train_gnn(spec, _args(b, 20), device="cpu")
    (pa, sa), (pb, sb) = _ckpt_params(a), _ckpt_params(b)
    assert sa == sb == 20 and set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert np.isfinite(loss)


def test_driver_skips_a_corrupt_checkpoint(tmp_path, capsys):
    spec = get_arch("gatedgcn")
    ck = tmp_path / "ck"
    ttrain.main(["--arch", "gatedgcn", "--steps", "20", "--ckpt-dir",
                 str(ck)], device="cpu")
    newest = ck / "ckpt_0000000020"
    leaf = newest / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    capsys.readouterr()
    ttrain.train_gnn(spec, _args(ck, 20), device="cpu")
    assert "resumed from step 10" in capsys.readouterr().out
    # the paper's own workload runs its smoke run: the distributed count
    # on one worker, held to Generic Join's, then the driver's last line
    capsys.readouterr()
    ttrain.main(["--arch", "wcoj-subgraph", "--ckpt-dir", str(ck)],
                device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith('smoke {"count": 4389.0,')
    assert lines[-1] == "final loss 0.0000"


def test_entry_points_default_to_the_card():
    """``GNN``, ``motif_features``, ``smoke_batch`` and the driver run on
    the card unless given ``device="cpu"``: without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run there")
    cfg = get_arch("gat-cora").smoke_config
    g = Graph.from_edges(uniform_graph(50, 200, seed=0), 50)
    for make in (lambda: TG.GNN(cfg), lambda: motif_features(g),
                 lambda: smoke_batch(cfg),
                 lambda: ttrain.train_gnn(get_arch("gat-cora"),
                                          _args("unused", 1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert {p.device.type for p in TG.GNN(cfg, device="cpu").parameters()
            } == {"cpu"}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    from repro.optim import schedules as js
    from repro_torch.optim import schedules as ts
    pairs = [(ts.constant(3e-4), js.constant(3e-4)),
             (ts.linear_warmup(1e-3, 100), js.linear_warmup(1e-3, 100)),
             (ts.cosine_decay(1e-3, 100, 10_000),
              js.cosine_decay(1e-3, 100, 10_000))]
    for t, j in pairs:
        for step in (0, 1, 7, 99, 100, 101, 5_000, 10_000, 20_000):
            want = np.float32(j(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(np.float32(t(step)), want, rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 0.0, 1e3])
def test_adamw_update_matches_jax(max_norm):
    """Weight decay on ndim >= 2 leaves only, clipping (or only reporting
    the norm), bias correction: two updates against the JAX package's."""
    from repro.optim import adamw_update as j_adamw_update
    from repro_torch.optim import adamw_update
    rng = np.random.default_rng(2)
    shapes = {"w": (5, 3), "b": (3,), "s": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt, jopt = adamw_init(tparams), j_adamw_init(jparams)
    for i in range(2):
        grads = {k: (3 * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        gn = adamw_update(tparams, {k: torch.from_numpy(v) for k, v in
                                    grads.items()}, opt, lr=1e-2,
                          weight_decay=0.1, max_grad_norm=max_norm)
        jparams, jopt, jgn = j_adamw_update(
            jparams, {k: jnp.asarray(v) for k, v in grads.items()}, jopt,
            lr=1e-2, weight_decay=0.1, max_grad_norm=max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    assert opt.step == int(jopt.step) == 2
    for k in shapes:
        for got, want in ((tparams[k], jparams[k]), (opt.mu[k], jopt.mu[k]),
                          (opt.nu[k], jopt.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("max_norm", [1.0, 0.0])
def test_adamw_update_sliced_matches_whole_and_jax(max_norm, monkeypatch):
    """The update taken CHUNK elements of a leaf at a time (CHUNK = 7
    splits every leaf of more than 7 elements unevenly; the transposed
    leaf is not contiguous and is updated whole) is bit for bit the
    update taken whole, and matches the JAX package's."""
    from repro.optim import adamw_update as j_adamw_update
    from repro_torch.optim import adamw as tadamw
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 3), "b": (3,), "s": (2, 2, 5), "t": (4, 6)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (3 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]

    def run(chunk):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        tp["t"] = torch.from_numpy(params["t"].T.copy()).T
        assert not tp["t"].is_contiguous()
        opt = tadamw.adamw_init(tp)
        norms = [float(tadamw.adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, opt,
            lr=1e-2, weight_decay=0.1, max_grad_norm=max_norm))
            for g in grads]
        return tp, opt, norms

    sp, sopt, sn = run(7)
    wp, wopt, wn = run(1 << 24)
    assert sn == wn
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = j_adamw_init(jparams)
    for g in grads:
        jparams, jopt, jgn = j_adamw_update(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jopt,
            lr=1e-2, weight_decay=0.1, max_grad_norm=max_norm)
    np.testing.assert_allclose(sn[-1], float(jgn), rtol=1e-6)
    for k in shapes:
        for got, whole, want in ((sp[k], wp[k], jparams[k]),
                                 (sopt.mu[k], wopt.mu[k], jopt.mu[k]),
                                 (sopt.nu[k], wopt.nu[k], jopt.nu[k])):
            assert torch.equal(got, whole), k
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """One package's checkpoint reads in the other (same manifest, one
    raw-bytes .npy per leaf, sorted keys); retention keeps the newest
    ``keep_last`` and clears a crashed writer's ``.tmp``."""
    from repro.checkpoint import load_raw as j_load_raw
    from repro.checkpoint import save_pytree as j_save_pytree
    from repro_torch.checkpoint import CheckpointManager, load_pytree
    from repro_torch.checkpoint import load_raw
    rng = np.random.default_rng(4)
    tree = {"params": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                       "b": np.arange(2, dtype=np.float32)},
            "opt": {"step": np.asarray(7, np.int32)}}
    ttree = {"params": {k: torch.from_numpy(v.copy())
                        for k, v in tree["params"].items()},
             "opt": {"step": 7}}
    mgr = CheckpointManager(str(tmp_path / "t"), keep_last=3)
    for s in range(1, 6):
        path = mgr.save(ttree, s)
    (tmp_path / "t" / "ckpt_0000000009.tmp").mkdir()
    mgr.save(ttree, 6)
    assert mgr.all_steps() == [4, 5, 6]
    assert sorted(os.listdir(tmp_path / "t")) == [
        f"ckpt_{s:010d}" for s in (4, 5, 6)]
    j_path = j_save_pytree(tree, str(tmp_path / "j"), 7)
    for mine, theirs in ((path, j_path), (j_path, path)):
        a, ma = load_raw(mine)
        b, mb = j_load_raw(theirs)
        assert [(r["name"], r["dtype"], r["shape"]) for r in ma["leaves"]] \
            == [(r["name"], r["dtype"], r["shape"]) for r in mb["leaves"]]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got, _ = load_pytree(ttree, j_path)
    assert got["opt"]["step"] == 7
    torch.testing.assert_close(got["params"]["w"], ttree["params"]["w"],
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        load_pytree({"params": ttree["params"]}, j_path)
