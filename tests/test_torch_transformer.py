"""The port's LM transformer on the CPU against the JAX package: the
smoke configs of the three dense archs (yi-34b: GQA, SwiGLU; gemma-7b:
GeGLU, 1 + w norms, embedding scale; gemma2-2b: window 8 on alternate
layers, attention and final softcaps; the MoE archs' are
``tests/test_torch_moe.py``'s) with the JAX parameters carried
across by ``convert.transformer_params``; configs, token batches and the
parameter conversion exactly.

Tolerance: f32 rtol 1e-4 / atol 1e-4 on hidden states, logits, losses
and caches of magnitude up to about 4: the packages run the same f32
arithmetic with sums in another order (XLA's dots against torch's; in
prefill and decode one softmax over masked scores in XLA against the
flash kernel's plain version), which leaves them 1e-6 to 1e-5 apart."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as JA
from repro.configs import lm_family as JF
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.configs import get_arch
from repro_torch.configs import lm_archs as TA
from repro_torch.configs import lm_family as TF
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import transformer as TT

DENSE = ["YI_34B", "GEMMA_7B", "GEMMA2_2B"]
ALL = ["LLAMA4_SCOUT", "MIXTRAL_8X7B"] + DENSE
TOL = dict(rtol=1e-4, atol=1e-4)
# config fields with no meaning on one card (activation checkpointing,
# the dry-run's unrolled scans, the mesh's data parallelism)
DROPPED = {"remat", "scan_unroll", "pure_dp"}
DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
B, S, SMAX = 2, 6, 10
# decode positions: inside the window of 8, at its edge, one whose window
# excludes keys 0-1, and one past the cache whose write clamps to the
# last slot (dynamic_update_slice)
DECODE_POS = [6, 7, 9, 13]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return x.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module", params=DENSE)
def run(request):
    return both_packages(request.param)


def both_packages(name):
    """One arch's smoke config through both packages from the same
    parameters and tokens: forward, logits, loss, prefill and the decode
    steps of DECODE_POS from a cache holding the prefill's k/v."""
    jc = getattr(JA, name).smoke_config
    tc = getattr(TA, name).smoke_config
    params = JT.init(jax.random.PRNGKey(3), jc)
    model = convert.transformer_params(_np(params), tc, device="cpu")
    b = JTokenStream(jc.vocab, B, S + len(DECODE_POS), seed=5).batch_at(0)
    tokens, labels = b[:, :S], b[:, 1:S + 1]
    out = {"j": {}, "t": {}}
    j, t = out["j"], out["t"]

    fwd = jax.jit(lambda p, x: JT.forward(p, x, jc))
    j["hidden"], j["aux"] = fwd(params, jnp.asarray(tokens))
    j["logits"] = jax.jit(lambda p, h: JT.logits_fn(p, h, jc))(
        params, j["hidden"])
    j["loss"], aux = jax.jit(lambda p, bt: JT.loss_fn(p, bt, jc))(
        params, {"tokens": jnp.asarray(tokens),
                 "labels": jnp.asarray(labels)})
    j["ce"] = aux["ce"]
    j["prefill"], jcache = jax.jit(lambda p, x: JT.prefill(p, x, jc))(
        params, jnp.asarray(tokens))
    j["prefill_k"], j["prefill_v"] = jcache["k"], jcache["v"]

    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        t["hidden"], t["aux"] = TT.forward(model, tt)
        t["logits"] = TT.logits_fn(model, t["hidden"])
        t["loss"], aux = TT.loss_fn(
            model, {"tokens": tt, "labels": torch.from_numpy(labels)})
        t["ce"] = aux["ce"]
    t["prefill"], tcache = TT.prefill(model, tt)
    t["prefill_k"], t["prefill_v"] = tcache["k"], tcache["v"]

    # both decodes start from the same cache: JAX's prefill k/v
    start = np.zeros((jc.num_layers, B, SMAX, jc.n_kv_heads, jc.head_dim),
                     np.float32)
    ck, cv = start.copy(), start.copy()
    ck[:, :, :S] = np.asarray(jcache["k"])
    cv[:, :, :S] = np.asarray(jcache["v"])
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    tcache = TT.make_cache(tc, B, SMAX, device="cpu")
    tcache["k"].copy_(torch.from_numpy(ck))
    tcache["v"].copy_(torch.from_numpy(cv))
    step = jax.jit(lambda p, c, x, q: JT.decode_step(p, c, x, q, jc))
    for n, pos in enumerate(DECODE_POS):
        x = b[:, S + n:S + n + 1]
        j[f"decode{pos}"], jcache = step(params, jcache, jnp.asarray(x),
                                         jnp.asarray(pos, jnp.int32))
        lg, same = TT.decode_step(model, tcache, torch.from_numpy(x), pos)
        assert same is tcache  # written in place
        t[f"decode{pos}"] = lg
        j[f"cache{pos}_k"], j[f"cache{pos}_v"] = jcache["k"], jcache["v"]
        t[f"cache{pos}_k"] = tcache["k"].clone()
        t[f"cache{pos}_v"] = tcache["v"].clone()
    return out


KEYS = (["hidden", "aux", "logits", "loss", "ce", "prefill", "prefill_k",
         "prefill_v"]
        + [f"decode{p}" for p in DECODE_POS]
        + [f"cache{p}_{kv}" for p in DECODE_POS for kv in "kv"])


@pytest.mark.parametrize("key", KEYS)
def test_matches_jax(run, key):
    want = np.asarray(run["j"][key], np.float32)
    got = _t(run["t"][key])
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, **TOL)


def test_clamped_write_lands_in_the_last_slot(run):
    """pos 13 past a 10-slot cache writes slot 9 and leaves 0-8 as the
    step before left them."""
    before, after = run["t"]["cache9_k"], run["t"]["cache13_k"]
    torch.testing.assert_close(after[:, :, :9], before[:, :, :9], rtol=0,
                               atol=0)
    assert not torch.equal(after[:, :, 9], before[:, :, 9])


def test_bf16_convert_round_trip_is_exact():
    jc = dataclasses.replace(JA.GEMMA2_2B.smoke_config,
                             param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(TA.GEMMA2_2B.smoke_config,
                             param_dtype=torch.bfloat16)
    params = _np(JT.init(jax.random.PRNGKey(0), jc))
    model = convert.transformer_params(params, tc, device="cpu")
    own = dict(model.named_parameters())
    flat = {"embed": params["embed"], "final_norm": params["final_norm"],
            **{f"layers.{k}": v for k, v in params["layers"].items()}}
    assert set(own) == set(flat)
    for name, arr in flat.items():
        assert arr.dtype.name == "bfloat16"
        assert own[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(_t(own[name]),
                                      arr.astype(np.float32))


@pytest.mark.parametrize("args", [(199, 2, 16, 0, 0, 1, 0),
                                  (256000, 4, 64, 7, 1, 3, 5),
                                  (50, 1, 9, 3, 0, 1, 2)])
def test_token_stream_equals_jax(args):
    vocab, batch, seq, seed, shard, shards, step = args
    got = TokenStream(vocab, batch, seq, seed, shard, shards).batch_at(step)
    want = JTokenStream(vocab, batch, seq, seed, shard, shards).batch_at(
        step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    first = next(iter(TokenStream(vocab, batch, seq, seed, shard, shards)))
    np.testing.assert_array_equal(
        first, TokenStream(vocab, batch, seq, seed, shard,
                           shards).batch_at(0))


def _same_config(t, j):
    fields = {f.name for f in dataclasses.fields(j)}
    own = {f.name for f in dataclasses.fields(t)}
    assert own == fields - DROPPED
    for name in own:
        a, b = getattr(t, name), getattr(j, name)
        assert a == DTYPE.get(b, b), name
    np.testing.assert_array_equal(t.layer_windows(), j.layer_windows())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.is_moe == j.is_moe


@pytest.mark.parametrize("name", ALL)
def test_configs_equal_jax(name):
    t, j = getattr(TA, name), getattr(JA, name)
    assert (t.arch_id, t.family, t.describe) == (j.arch_id, j.family,
                                                  j.describe)
    _same_config(t.full_config, j.full_config)
    _same_config(t.smoke_config, j.smoke_config)
    assert TF.SHAPES == JF.SHAPES
    for shape in TF.SHAPES:
        assert t.model_flops(shape) == j.model_flops(shape)
    assert t.smoke_run is not None
    assert t in TA.LM_ARCHS
    assert get_arch(t.arch_id) is t


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TA.GEMMA2_2B.smoke_config
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_cache(cfg, 1, 8)
