"""LM training on the port against the JAX package, on the CPU.

- ``configs.lm_family.make_train_step`` at M = 1 and 2 microbatches
  (gradient accumulation in f32) for the mixtral (MoE top-2),
  llama4-scout (MoE top-1) and gemma2-2b (softcaps, local/global) smoke
  configs: two steps from the same parameters (``convert.
  transformer_params``) on the same ``TokenStream`` batches; each step's
  loss and pre-clip gradient norm, then every parameter and both AdamW
  moments, by name, and the step counter.
- ``convert.adamw_state`` carries a JAX ``AdamWState`` across exactly.
- Each LM arch's ``smoke_run`` is finite; ``launch.train`` trains every
  LM arch's smoke config, and run to step 10 and relaunched to 20 it
  ends bit for bit where an uninterrupted 20-step run ends (one thread).
- The twin of ``examples/train_lm.py`` runs on the CPU at a small width.

Tolerance: f32 rtol 1e-4 / atol 1e-4 on losses and norms, as
``tests/test_torch_transformer.py`` states (the same f32 arithmetic with
sums in another order).  The steps run at a constant learning rate of
1e-3, so every parameter moves by about that much.  Each moment is held to
JAX's at rtol 1e-4 with an atol of 1e-5 times that leaf's largest
magnitude (``nu`` is about g², far below any fixed atol).  Each
parameter's change over the two steps is held to JAX's at rtol 1e-4 with
a per-element atol: that moment atol carried through each step's update
lr·m̂/(√v̂ + eps), since Adam divides an element's first moment by its own
gradient scale and so turns a small gradient's rounding into a large part
of its move, plus two ulps of the leaf's largest parameter, since a change
is a difference of two f32 parameters.  One case runs the default
schedule, whose learning rate is 0 at step 0, to cover its wiring."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as JA
from repro.configs import lm_family as JF
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import schedules as JS
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs import lm_archs as TA
from repro_torch.configs import lm_family as TF
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw_init
from repro_torch.optim import schedules as TS

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["MIXTRAL_8X7B", "LLAMA4_SCOUT", "GEMMA2_2B"]
LM_IDS = ["llama4-scout-17b-a16e", "mixtral-8x7b", "yi-34b", "gemma-7b",
          "gemma2-2b"]
B, S = 4, 16
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" \
    / "torch_train_lm.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread: bit-exact restarts, and no oversubscribed host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3
MOMENT_ATOL = 1e-5  # times the leaf's largest |moment|


def _scheds(lr):
    """(JAX schedule, port schedule): a constant ``lr``, or the default."""
    if lr is None:
        return None, None
    return JS.constant(lr), TS.constant(lr)


@functools.lru_cache(maxsize=None)
def _jstep(name, M, lr=None):
    """The JAX train step of an arch's smoke config, jitted once."""
    return jax.jit(JF.make_train_step(getattr(JA, name).smoke_config,
                                      schedule=_scheds(lr)[0],
                                      microbatches=M))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _check_leaf(label, got, want, atol):
    """rtol 1e-4; ``atol`` a number or an array of the leaf's shape."""
    bad = np.abs(got - want) > atol + 1e-4 * np.abs(want)
    assert not bad.any(), (
        f"{label}: {bad.sum()} of {bad.size} elements; worst "
        f"{np.abs(got - want)[bad].max()}")


@pytest.mark.parametrize(
    "name,M,lr",
    [pytest.param(n, m, LR, id=f"{n}-{m}") for n in ARCHS for m in (1, 2)]
    + [pytest.param("MIXTRAL_8X7B", 1, None,
                    id="MIXTRAL_8X7B-1-default-schedule")])
def test_train_step_matches_jax(name, M, lr):
    jc = getattr(JA, name).smoke_config
    tc = getattr(TA, name).smoke_config
    params = JT.init(jax.random.PRNGKey(2), jc)
    p0 = _flat(params)
    model = convert.transformer_params(
        jax.tree_util.tree_map(np.asarray, params), tc, device="cpu")
    jopt, opt = jadamw_init(params), adamw_init(model)
    jstep = _jstep(name, M, lr)
    step = TF.make_train_step(tc, schedule=_scheds(lr)[1], microbatches=M)
    ts = JTokenStream(jc.vocab, B, S, seed=1)
    jmo = []
    for s in range(2):
        b = ts.batch_at(s)
        params, jopt, jm = jstep(params, jopt, {
            "tokens": jnp.asarray(b[:, :-1]), "labels": jnp.asarray(b[:, 1:])})
        jmo.append((_flat(jopt.mu), _flat(jopt.nu)))
        m = step(model, opt, TF.token_batch(b, "cpu"))
        want = ["loss", "gnorm"] + (["ce", "aux"] if M == 1 else [])
        assert sorted(m) == sorted(jm) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {s} {k}", **TOL)
    assert opt.step == int(jopt.step) == 2
    for label, got, tree in (("mu", opt.mu, jopt.mu), ("nu", opt.nu,
                                                       jopt.nu)):
        want = _flat(tree)
        assert set(got) == set(want)
        for k in want:
            _check_leaf(f"{label} {k}", got[k].numpy(), want[k],
                        MOMENT_ATOL * np.abs(want[k]).max())
    own = {k: p.detach().numpy() for k, p in model.named_parameters()}
    want = _flat(params)
    assert set(own) == set(want) == set(p0)
    sched = _scheds(lr)[1] or TS.cosine_decay(3e-4, 2000, 100_000)
    for k in want:
        moved, got = want[k] - p0[k], own[k] - p0[k]
        if lr is not None:
            # Adam's first steps move a parameter by about lr each.
            assert np.abs(moved).max() > 0.5 * lr, k
            assert np.abs(got).max() <= 3 * lr, k
        atol = 2 * np.spacing(np.abs(p0[k]).max())
        for t, (mu, nu) in enumerate(jmo, 1):
            atol = atol + sched(t - 1) * MOMENT_ATOL \
                * np.abs(mu[k]).max() / (1 - 0.9 ** t) \
                / (np.sqrt(nu[k] / (1 - 0.95 ** t)) + 1e-8)
        _check_leaf(f"param change {k}", got, moved, atol)


def test_adamw_state_converts_exactly():
    jc = JA.MIXTRAL_8X7B.smoke_config
    params = JT.init(jax.random.PRNGKey(0), jc)
    jopt = jadamw_init(params)
    b = JTokenStream(jc.vocab, B, S, seed=0).batch_at(0)
    params, jopt, _ = _jstep("MIXTRAL_8X7B", 1)(params, jopt, {
        "tokens": jnp.asarray(b[:, :-1]), "labels": jnp.asarray(b[:, 1:])})
    host = jax.tree_util.tree_map(np.asarray, jopt)
    model = convert.transformer_params(
        jax.tree_util.tree_map(np.asarray, params),
        TA.MIXTRAL_8X7B.smoke_config, device="cpu")
    opt = convert.adamw_state(host, model, device="cpu")
    assert opt.step == 1
    for got, tree in ((opt.mu, host.mu), (opt.nu, host.nu)):
        want = _flat(tree)
        assert set(got) == set(want) == {k for k, _ in
                                         model.named_parameters()}
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError):
        convert.adamw_state(host, convert.transformer_params(
            jax.tree_util.tree_map(np.asarray, JT.init(
                jax.random.PRNGKey(0), JA.YI_34B.smoke_config)),
            TA.YI_34B.smoke_config, device="cpu"), device="cpu")


@pytest.mark.parametrize("arch", LM_IDS)
def test_smoke_run_is_finite_and_the_driver_trains(arch, tmp_path, capsys):
    spec = get_arch(arch)
    m = spec.smoke_run(device="cpu")
    assert np.isfinite(m["loss_first"]) and np.isfinite(m["loss_last"])
    loss = ttrain.main(["--arch", arch, "--steps", "2", "--batch", "2",
                        "--seq", "16", "--log-every", "1", "--ckpt-dir",
                        str(tmp_path)], device="cpu")
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "tok/s" in out
    assert np.isfinite(loss)


def _args(ck, steps):
    return ["--arch", "mixtral-8x7b", "--steps", str(steps), "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(ck)]


def test_train_lm_resumes_bit_for_bit(tmp_path, capsys):
    """To step 10, relaunched to 20 (one directory), against 20 steps in
    another: the same loss and the same parameters and moments."""
    a, b = tmp_path / "a", tmp_path / "b"
    ttrain.main(_args(a, 10), device="cpu")
    capsys.readouterr()
    resumed = ttrain.main(_args(a, 20), device="cpu")
    assert "resumed from step 10" in capsys.readouterr().out
    whole = ttrain.main(_args(b, 20), device="cpu")
    assert resumed == whole and np.isfinite(whole)
    from repro_torch.checkpoint import load_raw
    la, ma = load_raw(str(a / "ckpt_0000000020"))
    lb, mb = load_raw(str(b / "ckpt_0000000020"))
    assert [r["name"] for r in ma["leaves"]] == \
        [r["name"] for r in mb["leaves"]]
    for x, y, r in zip(la, lb, ma["leaves"]):
        np.testing.assert_array_equal(x, y, err_msg=r["name"])


def test_bf16_train_state_round_trips(tmp_path):
    """A bf16 model's checkpoint keeps its parameters' bits."""
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(TA.GEMMA2_2B.smoke_config,
                              param_dtype=torch.bfloat16)
    model = Transformer(cfg, seed=0, device="cpu")
    opt = adamw_init(model)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(ttrain.train_state(model, opt), 1)
    other = Transformer(cfg, seed=1, device="cpu")
    oopt = adamw_init(other)
    state, _ = mgr.restore_latest(ttrain.train_state(other, oopt))
    ttrain.load_state(other, oopt, state)
    for (k, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert q.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), k


def test_example_twin_runs_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("torch_train_lm", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--steps", "40", "--d-model", "128", "--layers", "2",
                       "--vocab", "1024", "--seq", "64", "--batch", "4",
                       "--ckpt-dir", str(tmp_path)], device="cpu")
    assert "improved ✓" in capsys.readouterr().out
    assert len(losses) == 40
