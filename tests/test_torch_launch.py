"""The port's launch drivers on the CPU: ``launch.serve`` in its stream,
concurrent and LM modes and ``launch.run_query`` in its static, delta and
serial modes, against the JAX drivers and the JAX package's serial
Generic-Join oracle.

LM tolerance: f32 rtol 1e-4 / atol 1e-4 on the prefill logits (the
packages run the same f32 arithmetic with sums in another order, as in
``tests/test_torch_transformer.py``); the greedy tokens are equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Graph as JGraph, oracle_count as joracle_count
from repro.configs import lm_archs as JA
from repro.core import delta as jdelta
from repro.data.synthetic import rmat_graph as jrmat_graph
from repro.launch import run_query as jrun_query, serve as jlaunch
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import lm_archs as TA
from repro_torch.launch import run_query, serve

TOL = dict(rtol=1e-4, atol=1e-4)
STREAM = ["--scale", "7", "--epochs", "2", "--batch-size", "64", "--verify"]


@pytest.fixture(autouse=True)
def _jax_plain(monkeypatch):
    """The JAX session on its plain jnp paths, as in
    ``tests/test_torch_serve.py``."""
    import repro.api.session as jsession
    from repro.core.bigjoin import BigJoinConfig as JConfig
    monkeypatch.setattr(jsession, "BigJoinConfig",
                        functools.partial(JConfig, use_kernel=False))
    monkeypatch.setattr(jdelta, "USE_MERGE_KERNEL", False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("query", ["triangle", "triangle,diamond"])
def test_serve_stream_verifies_and_matches_jax(query, capsys):
    """``--stream --verify``: the maintained totals equal a recomputation
    (``serve.main`` raises otherwise) and the JAX ``launch.serve``'s,
    epoch for epoch."""
    argv = ["--stream", "--query", query] + STREAM
    net = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("✓") == len(query.split(","))
    assert net == jlaunch.main(argv + ["--local"])
    jout = capsys.readouterr().out
    epochs = [ln.split(" in ")[0] for ln in out.splitlines()
              if ln.startswith("  epoch")]
    assert epochs == [ln.split(" in ")[0] for ln in jout.splitlines()
                      if ln.startswith("  epoch")]


def test_serve_concurrent_verifies(capsys):
    stats = serve.main(["--concurrent", "2", "--device", "cpu"] + STREAM)
    out = capsys.readouterr().out
    assert out.count("✓") == 2
    agg = stats.aggregate()
    assert agg["tenants"] == 2 and agg["retired"] == 4
    assert agg["serve_compiles"] == 0


def test_serve_refuses_what_is_not_ported():
    # the mesh's --workers/--balance are ported (test_torch_mesh_stream)
    with pytest.raises(KeyError):
        serve.main(["--arch", "gatedgcn", "--device", "cpu"])


def test_serve_lm_decode_loop_matches_jax():
    """gemma2-2b's smoke config (f32): the JAX driver's parameters (drawn
    from its seed) through ``convert.transformer_params`` and its prompts
    into the port's decode loop give the JAX prefill logits and the JAX
    driver's greedy tokens; the port's own driver runs on its own
    parameters."""
    _decode_loop_matches_jax("GEMMA2_2B", "gemma2-2b")


def test_serve_lm_moe_decode_loop_matches_jax():
    """The same for mixtral-8x7b's smoke config (MoE, top-2)."""
    _decode_loop_matches_jax("MIXTRAL_8X7B", "mixtral-8x7b")


def _decode_loop_matches_jax(name, arch):
    seed, batch, prompt_len, steps = 0, 2, 8, 4
    jc = getattr(JA, name).smoke_config
    tc = getattr(TA, name).smoke_config
    params = JT.init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, jc.vocab, (batch, prompt_len)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: JT.prefill(p, t, jc))(
        params, jnp.asarray(prompts))
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--steps", str(steps), "--seed", str(seed)]
    jtoks = jlaunch.main(argv)
    model = convert.transformer_params(
        jax.tree_util.tree_map(np.asarray, params), tc, device="cpu")
    logits, toks, last, _, _ = serve.greedy_decode(
        model, torch.from_numpy(prompts), steps)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert torch.isfinite(last).all()
    own = serve.main(argv + ["--device", "cpu"])
    assert own.shape == (batch, steps)


@pytest.mark.parametrize("mode", ["static", "delta", "serial"])
def test_run_query_modes_against_the_oracle(mode, capsys):
    """Each mode's count (static, serial) or maintained change (delta: the
    last update batches streamed onto the rest, ``--verify`` on) against
    the JAX package's serial Generic-Join oracle over the JAX package's
    graph from the same seed, and each printed result line against the
    JAX ``run_query``'s."""
    argv = ["--mode", mode, "--scale", "7", "--update-batches", "2",
            "--update-size", "100"]
    got = run_query.main(argv + ["--device", "cpu"] +
                         (["--verify"] if mode == "delta" else []))
    out = capsys.readouterr().out
    jrun_query.main(argv)
    jout = capsys.readouterr().out
    edges = JGraph.from_edges(jrmat_graph(7, 8, seed=0)).edges
    if mode == "delta":
        n0 = edges.shape[0] - 200
        want = joracle_count("triangle", edges) - \
            joracle_count("triangle", edges[:n0])
        assert "recompute diff ✓" in out
    else:
        want = joracle_count("triangle", edges)
    assert got == want

    def results(text):
        return [ln.split(" results")[0] for ln in text.splitlines()
                if " results" in ln]
    assert results(out) and results(out) == results(jout)


def test_run_query_distributed_needs_the_mesh(capsys):
    """The distributed mode counts on a mesh session of ``--workers``,
    the count the oracle's."""
    cnt = run_query.main(["--mode", "distributed", "--device", "cpu",
                          "--workers", "2", "--scale", "6", "--verify"])
    out = capsys.readouterr().out
    assert "w=2 mesh" in out and "✓" in out and cnt > 0
    with pytest.raises(ValueError):
        run_query.main(["--mode", "distributed", "--device", "cpu",
                        "--workers", "0", "--scale", "6"])
