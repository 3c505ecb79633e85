"""The port's MoE layer (``models.transformer._moe_mlp``: sort-based,
capacity-bounded dispatch) and the two MoE archs' smoke models on the CPU
against the JAX package, from the same parameters (carried across by
``convert.transformer_params``) and inputs.

- ``_moe_mlp`` alone: outputs, the Switch aux loss, and the gradients of
  x and of every MoE leaf, top-1 (llama4-scout) and top-2 (mixtral), at
  a token count that is not a multiple of 8; and a batch of 40 whose
  router sends every token to one expert, so that the capacity drops
  assignments: each token's experts and each assignment's kept bit
  equal the JAX package's exactly (the JAX routing recomputed from its
  own primitives, reference ``models/transformer.py:291-306``).
- The smoke models: forward (through ``_attend``), logits, loss, prefill
  and the decode steps through the flash kernel's plain version, as
  ``tests/test_torch_transformer.py`` holds the dense archs.

Tolerance: f32 rtol 1e-4 / atol 1e-4, as ``tests/test_torch_transformer.py``
states: the same f32 arithmetic with sums in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as JA
from repro.models import transformer as JT
from repro_torch import kernels as tkernels
from repro_torch.configs import lm_archs as TA
from repro_torch.models import transformer as TT

from test_torch_transformer import KEYS, both_packages

MOE = ["MIXTRAL_8X7B", "LLAMA4_SCOUT"]
TOL = dict(rtol=1e-4, atol=1e-4)
LEAVES = ("router", "w_in", "w_out")


@pytest.fixture(autouse=True)
def _no_launches():
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer0(name, seed=1):
    """Layer 0's MoE leaves of the arch's smoke config as numpy."""
    jc = getattr(JA, name).smoke_config
    params = JT.init(jax.random.PRNGKey(seed), jc)
    return jc, getattr(TA, name).smoke_config, {
        k: np.array(params["layers"][k][0]) for k in LEAVES}


def _jax_routing(x, lp, cfg):
    """The JAX package's routing (reference ``_moe_mlp``'s first lines):
    each assignment's expert id (token-major, [T*k]) and kept bit."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(cfg.capacity_factor * T * k / E / 8) * 8)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x, lp["router"]
                                      ).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    ids = topi.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(ids, stable=True).astype(jnp.int32)
    sid = ids[order]
    rank = jnp.arange(T * k, dtype=jnp.int32) \
        - jnp.searchsorted(sid, sid, side="left").astype(jnp.int32)
    keep = np.zeros(T * k, bool)
    keep[np.asarray(order)] = np.asarray(rank < C)
    return np.asarray(ids), keep


def _run_both(name, T, seed, overload=False):
    jc, tc, lp = _layer0(name, seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, jc.d_model)).astype(np.float32)
    if overload:  # every token's first choice is expert 0
        lp["router"][:, 0] = 0.0
        x[:, 0] = np.abs(x[:, 0]) + 1.0
        lp["router"][0, 0] = 6.0
    cot = rng.normal(size=(T, jc.d_model)).astype(np.float32)

    def jloss(x, lp):
        out, aux = JT._moe_mlp(x, lp, jc)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tlp = {k: torch.from_numpy(v.copy()).requires_grad_()
           for k, v in lp.items()}
    tout, taux = TT._moe_mlp(tx, tlp, tc)
    (torch.sum(tout * torch.from_numpy(cot)) + taux).backward()
    j = {"out": jout, "aux": jaux, "dx": jgrads[0],
         **{f"d{k}": jgrads[1][k] for k in LEAVES}}
    t = {"out": tout, "aux": taux, "dx": tx.grad,
         **{f"d{k}": tlp[k].grad for k in LEAVES}}
    return jc, x, lp, j, t


@pytest.mark.parametrize("name", MOE)
def test_moe_mlp_matches_jax(name):
    """Outputs, aux and gradients at T = 13 tokens, not a multiple of 8
    (``test_capacity_drops_match_jax`` holds T = 40)."""
    _, _, _, j, t = _run_both(name, 13, seed=13)
    for key in j:
        want = np.asarray(j[key], np.float32)
        got = t[key].detach().numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)


@pytest.mark.parametrize("name", MOE)
def test_capacity_drops_match_jax(name):
    """A router that sends every token to expert 0 first: assignments past
    the capacity are dropped, in both packages the same ones, and the
    outputs and gradients still agree."""
    T = 40
    jc, x, lp, j, t = _run_both(name, T, seed=7, overload=True)
    tc = getattr(TA, name).smoke_config
    ids, keep = _jax_routing(jnp.asarray(x), lp, jc)
    C = int(np.ceil(jc.capacity_factor * T * jc.top_k / jc.n_experts / 8)
            * 8)
    assert (ids == 0).sum() == T > C  # expert 0 overloaded
    assert 0 < keep.sum() < T * jc.top_k
    route = TT._route(torch.from_numpy(x), torch.from_numpy(
        lp["router"]), tc)
    np.testing.assert_array_equal(route["ids"].numpy(), ids)
    kept = np.zeros(T * jc.top_k, bool)  # token-major
    kept[route["order"].numpy()] = route["kept"].numpy()
    np.testing.assert_array_equal(kept, keep)
    assert route["capacity"] == C
    for key in j:
        np.testing.assert_allclose(t[key].detach().numpy(),
                                   np.asarray(j[key], np.float32),
                                   err_msg=key, **TOL)


@pytest.fixture(scope="module", params=MOE)
def run(request):
    return both_packages(request.param)


@pytest.mark.parametrize("key", KEYS)
def test_moe_model_matches_jax(run, key):
    want = np.asarray(run["j"][key], np.float32)
    got = run["t"][key].detach().to(torch.float32).numpy()
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_init_has_the_jax_leaves(name):
    """``init`` draws the JAX package's MoE leaves: names and shapes, and
    He scales of fan-in d and ff."""
    jc, tc = getattr(JA, name).full_config, getattr(TA, name).full_config
    jshapes = jax.tree_util.tree_map(lambda a: a.shape,
                                     JT.abstract_params(jc))
    with torch.device("meta"):  # shapes only: nothing is drawn
        tree = TT.init(torch.Generator(), tc)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tree) == \
        jax.tree_util.tree_map(tuple, jshapes,
                               is_leaf=lambda a: isinstance(a, tuple))
    sc = getattr(TA, name).smoke_config
    layers = TT.init(torch.Generator().manual_seed(0), sc)["layers"]
    for k, fan in (("router", sc.d_model), ("w_in", sc.d_model),
                   ("w_out", sc.d_ff)):
        std = float(layers[k].std())
        assert abs(std - (2.0 / fan) ** 0.5) < 0.1 * (2.0 / fan) ** 0.5, k
