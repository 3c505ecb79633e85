"""The port's ``distributed`` modules against the JAX package's, on the
CPU.

- ``sharding.ShardingRules.physical`` over the two production mesh shapes,
  (data 16, model 16) and (pod 2, data 16, model 16), for every leaf of
  ``logical_axes`` of the five full LM configs at their shapes, for the
  KV cache at the decode_32k and long_500k shapes, and without shapes;
  the JAX side maps onto ``jax.sharding.AbstractMesh`` (no devices).  A
  rule declared as a tuple keeps the tuple form in the port; the JAX
  ``PartitionSpec`` spells a one-axis tuple as the axis name, so specs
  are compared with that spelling.
- ``collectives.quantize_int8``/``dequantize_int8`` exactly.
- ``compressed_psum`` (50 error-feedback steps) and
  ``psum_scatter_matmul`` against the JAX package's inside ``shard_map``
  on 4 host devices, run in one subprocess: each step's residual at atol
  3e-5 (2 f32 ulps of the largest input, ~130: XLA fuses ``x - q *
  scale`` and rounds once where the port rounds twice), the reduced mean
  at rtol 1e-6 / atol 1e-5 (a sum of four f32 scales in another order),
  the matmul at rtol 1e-5 / atol 1e-4 (sums of 128 products of unit
  normals, magnitude ~10, in another order).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import lm_archs as JA
from repro.distributed import collectives as JC
from repro.distributed import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import lm_archs as TA
from repro_torch.distributed import collectives as TC
from repro_torch.distributed import sharding as TS
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["LLAMA4_SCOUT", "MIXTRAL_8X7B", "YI_34B", "GEMMA_7B", "GEMMA2_2B"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
W, STEPS = 4, 50
TOL = dict(rtol=1e-6, atol=1e-5)


def _spelled(spec):
    """A spec with one-axis tuples spelled as the axis name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_defaults_equal_jax():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    assert TS.ShardingRules.default().table == \
        JS.ShardingRules.default().table
    assert TS.ShardingRules.default(expert=None, seq="model").table == \
        JS.ShardingRules.default(expert=None, seq="model").table


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_physical_equals_jax(name, mesh):
    jc, tc = getattr(JA, name).full_config, getattr(TA, name).full_config
    sizes, names = MESHES[mesh]
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    axes = _leaves(TT.logical_axes(tc))
    assert axes == _leaves(JT.logical_axes(jc))
    shapes = {k: tuple(v.shape)
              for k, v in _leaves(JT.abstract_params(jc)).items()}
    cases = [(f"param {k}", axes[k], shapes[k]) for k in axes]
    cache_ax = TT.cache_logical_axes(tc)
    assert cache_ax == JT.cache_logical_axes(jc)
    assert TT.cache_logical_axes(tc, False) == \
        JT.cache_logical_axes(jc, False)
    for shape in ("decode_32k", "long_500k"):
        sh = {"decode_32k": (128, 32768), "long_500k": (1, 524288)}[shape]
        cases.append((f"cache {shape}", cache_ax["k"],
                      (jc.num_layers,) + sh + (jc.n_kv_heads, jc.head_dim)))
    cases += [(f"{label} unshaped", ax, None) for label, ax, _ in cases]
    cases.append(("batch", ("batch", None), (256, 4096)))
    cases.append(("batch_dp3", ("batch_dp3", None), (256, 4096)))
    trules, jrules = TS.ShardingRules.default(), JS.ShardingRules.default()
    for label, ax, shape in cases:
        got = trules.physical(ax, tmesh, shape)
        want = jrules.physical(ax, jmesh, shape)
        assert isinstance(got, tuple) and len(got) == len(ax), label
        assert _spelled(got) == tuple(want), (label, got, want)


def test_tuple_rules_keep_their_form():
    rules = TS.ShardingRules.default()
    mesh = {"data": 16, "model": 16}
    assert rules.physical(("batch", "embed"), mesh) == (("data",), None)
    assert rules.physical(("batch_dp3", None), mesh, (256, 8)) == \
        (("data", "model"), None)
    # 8 experts cannot take a 16-way axis: the mlp dim takes it
    assert rules.physical((None, "expert", "embed", "mlp"), mesh,
                          (32, 8, 4096, 28672)) == \
        (None, None, "data", "model")


def test_quantize_int8_exact():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(128,)).astype(np.float32),
              (rng.normal(size=(7, 33)) * 1e3).astype(np.float32),
              np.zeros(5, np.float32)):
        jq, js = JC.quantize_int8(jax.numpy.asarray(x))
        tq, ts = TC.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            TC.dequantize_int8(tq, ts).numpy(),
            np.asarray(JC.dequantize_int8(jq, js)))


_JAX_RUNNER = r"""
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.collectives import compressed_psum, psum_scatter_matmul

W, STEPS, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = Mesh(np.array(jax.devices()[:W]), ("x",))
rng = np.random.default_rng(0)
grads = rng.normal(size=(STEPS, W, 64)).astype(np.float32)
grads[:, 1] *= 30.0  # scales that differ by worker

@jax.jit
def step(g, r):
    return shard_map(lambda g, r: compressed_psum(g[0], r[0], "x"),
                     mesh=mesh, in_specs=(P("x"), P("x")),
                     out_specs=(P(), P("x")), check_vma=False)(g, r)

res = jnp.zeros((W, 64), jnp.float32)
means, residuals = [], []
for s in range(STEPS):
    m, res = step(jnp.asarray(grads[s]), res)
    res = res.reshape(W, 64)
    means.append(np.asarray(m))
    residuals.append(np.asarray(res))

x = rng.normal(size=(24, 4 * W * 8)).astype(np.float32)
w = rng.normal(size=(4 * W * 8, 16 * W)).astype(np.float32)
mm = jax.jit(shard_map(lambda a, b: psum_scatter_matmul(a, b, "x"),
                       mesh=mesh, in_specs=(P(None, "x"), P("x", None)),
                       out_specs=P(None, "x"), check_vma=False))
np.savez(out, grads=grads, means=np.stack(means),
         residuals=np.stack(residuals), x=x, w=w,
         mm=np.asarray(mm(jnp.asarray(x), jnp.asarray(w))))
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + f" --xla_force_host_platform_device_count={W}")
    run = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, str(W), str(STEPS), str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


def test_compressed_psum_matches_shard_map(jax_mesh):
    """Each step from the JAX package's residual of the step before (so
    that ulps do not random-walk through 50 steps); then the port's own
    50-step run, whose mean output converges to the true mean gradient
    (the error feedback's point) as the JAX package's does."""
    grads = torch.from_numpy(jax_mesh["grads"])
    prev = np.zeros((W, 64), np.float32)
    for s in range(STEPS):
        mean, res = TC.compressed_psum(grads[s], torch.from_numpy(prev))
        assert mean.shape == (64,) and res.shape == (W, 64)
        np.testing.assert_allclose(res.numpy(), jax_mesh["residuals"][s],
                                   rtol=0, atol=3e-5,
                                   err_msg=f"residual, step {s}")
        np.testing.assert_allclose(mean.numpy(), jax_mesh["means"][s],
                                   err_msg=f"mean, step {s}", **TOL)
        prev = jax_mesh["residuals"][s]
    res = torch.zeros((W, 64), dtype=torch.float32)
    total = torch.zeros(64)
    for s in range(STEPS):
        mean, res = TC.compressed_psum(grads[s], res)
        total += mean
    truth = jax_mesh["grads"].mean(1).mean(0)
    jerr = np.abs(jax_mesh["means"].mean(0) - truth).max()
    err = float((total / STEPS - torch.from_numpy(truth)).abs().max())
    assert err <= 2 * jerr + 1e-6, (err, jerr)


def test_psum_scatter_matmul_matches_shard_map(jax_mesh):
    x, w = jax_mesh["x"], jax_mesh["w"]
    ks, nw = x.shape[1] // W, w.shape[1] // W
    tx = torch.from_numpy(x).reshape(x.shape[0], W, ks).transpose(0, 1)
    tw = torch.from_numpy(w).reshape(W, ks, w.shape[1])
    got = TC.psum_scatter_matmul(tx.contiguous(), tw)
    assert got.shape == (W, x.shape[0], nw)
    whole = got.transpose(0, 1).reshape(x.shape[0], w.shape[1])
    np.testing.assert_allclose(whole.numpy(), jax_mesh["mm"], rtol=1e-5,
                               atol=1e-4)
    with pytest.raises(ValueError):
        TC.psum_scatter_matmul(tx.contiguous(), tw[:, :, :nw * W - 1])
