"""The two-tower recsys model of the port against the JAX package's, on the
CPU in f32: the event stream exactly; ``embedding_bag``, the loss, its
gradients and three ``make_train_step`` steps, ``serve_scores`` and
``retrieval_topk`` (its ids exactly), from the JAX package's parameters
carried across with ``convert.recsys_params``.  The JAX side runs its
``use_kernel=False`` path: its Pallas ``segment_sum`` has no gradient.

Tolerance: rtol 1e-5 and atol 1e-5 times the largest |value| of the array
compared: f32 matmuls and the gradients' sums over the batch run in
another order, which leaves an entry near zero of a gradient leaf ~1e-7
from the other package's (4e-5 of that entry)."""
import dataclasses

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    import jax
    from repro.configs.recsys_family import TWO_TOWER as JT
    from repro.models import recsys as JR
    from repro_torch.configs.recsys_family import TWO_TOWER as TT
    from repro_torch.convert import recsys_params
    jcfg = dataclasses.replace(JT.smoke_config, use_kernel=False)
    tcfg = TT.smoke_config
    jp = JR.init(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, recsys_params(host, tcfg, device="cpu")


def _batches(jcfg, step):
    import jax.numpy as jnp
    from repro_torch.configs.recsys_family import event_batch
    tb = event_batch(jcfg, 64, step, "cpu")
    jb = {"feats": {k: jnp.asarray(v.numpy()) for k, v in tb["feats"].items()},
          "item_ids": jnp.asarray(tb["item_ids"].numpy())}
    return jb, tb


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 0), (1, 5)])
def test_recsys_events_match_jax(step, seed):
    from repro.data.synthetic import recsys_events as jev
    from repro_torch.data.synthetic import recsys_events as tev
    args = (1000, 2000, 32, step, (1000, 500, 100))
    jf, ji, jl = jev(*args, multi_hot=8, seed=seed)
    tf, ti, tl = tev(*args, multi_hot=8, seed=seed)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


def test_embedding_bag_and_towers_match_jax(models):
    from repro.models import recsys as JR
    from repro_torch.models import recsys as TR
    jcfg, tcfg, jp, tp = models
    jb, tb = _batches(jcfg, 0)
    for name, _ in tcfg.user_tables:
        _close(TR.embedding_bag(tp["tables"][name],
                                tb["feats"][name]).detach(),
               JR.embedding_bag(jp["tables"][name], jb["feats"][name]), name)
    _close(TR.user_embedding(tp, tb["feats"], tcfg).detach(),
           JR.user_embedding(jp, jb["feats"], jcfg))
    _close(TR.item_embedding(tp, tb["item_ids"], tcfg).detach(),
           JR.item_embedding(jp, jb["item_ids"], jcfg))


def test_loss_and_gradients_match_jax(models):
    import jax
    from repro.models import recsys as JR
    from repro_torch.convert import _dotted, _lists_as_dicts
    from repro_torch.models import recsys as TR
    jcfg, tcfg, jp, tp = models
    jb, tb = _batches(jcfg, 1)
    (jloss, jm), jg = jax.value_and_grad(JR.loss_fn, has_aux=True)(
        jp, jb, jcfg)
    tp.zero_grad(set_to_none=True)
    tloss, tm = TR.loss_fn(tp, tb, tcfg)
    tloss.backward()
    _close(tloss.detach(), jloss, "loss")
    _close(tm["pos_score"], jm["pos_score"], "pos_score")
    want = _dotted(_lists_as_dicts(jax.tree_util.tree_map(np.asarray, jg)))
    got = {k: p.grad for k, p in tp.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    tp.zero_grad(set_to_none=True)


def test_three_train_steps_match_jax(models):
    import jax
    from repro.configs.recsys_family import make_train_step as jstep_of
    from repro.optim import adamw_init as jinit
    from repro_torch.configs.recsys_family import make_train_step
    from repro_torch.convert import _dotted, _lists_as_dicts, recsys_params
    from repro_torch.optim import adamw_init
    jcfg, tcfg, jp, _ = models
    tp = recsys_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                       device="cpu")
    jstep, tstep = jax.jit(jstep_of(jcfg)), make_train_step(tcfg)
    jopt, topt = jinit(jp), adamw_init(tp)
    for s in range(3):
        jb, tb = _batches(jcfg, s)
        jp, jopt, jm = jstep(jp, jopt, jb)
        tm = tstep(tp, topt, tb)
        _close(tm["loss"], jm["loss"], f"loss step {s}")
    want = _dotted(_lists_as_dicts(jax.tree_util.tree_map(np.asarray, jp)))
    for k, p in tp.named_parameters():
        _close(p.detach(), want[k], k)
    assert topt.step == int(jopt.step) == 3


def test_serve_and_retrieval_match_jax(models):
    import jax.numpy as jnp
    from repro.models import recsys as JR
    from repro_torch.models import recsys as TR
    jcfg, tcfg, jp, tp = models
    jb, tb = _batches(jcfg, 2)
    with torch.no_grad():
        _close(TR.serve_scores(tp, tb["feats"], tb["item_ids"], tcfg),
               JR.serve_scores(jp, jb["feats"], jb["item_ids"], jcfg))
        q = {k: v[:1] for k, v in tb["feats"].items()}
        vals, ids = TR.retrieval_topk(
            tp, q, torch.arange(tcfg.num_items, dtype=torch.int32), tcfg,
            k=25)
    jv, ji = JR.retrieval_topk(
        jp, {k: v[:1] for k, v in jb["feats"].items()},
        jnp.arange(jcfg.num_items, dtype=jnp.int32), jcfg, k=25)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    _close(vals, jv)


def test_init_and_param_count():
    from repro_torch.configs.recsys_family import TWO_TOWER
    from repro_torch.models import recsys as TR
    cfg = TWO_TOWER.smoke_config
    p = TR.init(cfg, seed=3, device="cpu")
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
    assert torch.equal(p["item_table"],
                       TR.init(cfg, seed=3, device="cpu")["item_table"])
    assert TWO_TOWER.full_config.param_count() == 3_097_600_000 + 2_362_880
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.init(cfg)


def test_train_cli_runs_the_recsys_arch(capsys):
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    assert get_arch("two-tower-retrieval").family == "recsys"
    loss = train.main(["--arch", "two-tower-retrieval"], device="cpu")
    assert np.isfinite(loss)
    assert f"final loss {loss:.4f}" in capsys.readouterr().out
