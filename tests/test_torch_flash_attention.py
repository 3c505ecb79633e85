"""The port's flash attention on the CPU (its plain version) against the
JAX package's Pallas kernel run as its own tests run it (interpret mode)
and against its jnp reference.

Tolerances are the JAX package's own (``tests/test_kernels.py``): f32
3e-4, since the blocked kernel adds its online softmax in another order
than one softmax over every key; bf16 2e-2, since the two round the
output to bf16 from f32 values that differ in the last bits."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import _flash_call
from repro.kernels.flash_attention.ops import mha as j_mha
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch import kernels as tkernels
from repro_torch.kernels.flash_attention import flash_attention, mha
from repro_torch.kernels.flash_attention.ref import attention_ref

CASES = [
    dict(H=2, Sq=256, Sk=256, Dh=64, causal=True, window=0, softcap=0.0),
    dict(H=1, Sq=200, Sk=200, Dh=32, causal=True, window=64, softcap=0.0),
    dict(H=2, Sq=130, Sk=130, Dh=64, causal=True, window=0, softcap=30.0),
    dict(H=1, Sq=1, Sk=300, Dh=64, causal=True, window=0, softcap=0.0,
         q_offset=299),
    dict(H=1, Sq=100, Sk=100, Dh=128, causal=False, window=0, softcap=0.0),
    dict(H=1, Sq=64, Sk=64, Dh=256, causal=True, window=0, softcap=0.0),
]
DTYPES = {"f32": (np.float32, torch.float32, 3e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds to nearest even in both)."""
    jd, td, _ = DTYPES[dtype]
    return (jnp.asarray(arr, jd),
            torch.from_numpy(arr.astype(np.float32)).to(td))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"S{c['Sq']}x{c['Sk']}d{c['Dh']}"
                         f"{'c' if c['causal'] else ''}"
                         f"{'w' + str(c['window']) if c['window'] else ''}"
                         f"{'cap' if c['softcap'] else ''}")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax_kernel(case, dtype):
    c = dict(case)
    qo = c.pop("q_offset", 0)
    rng = np.random.default_rng(c["Sq"])
    jq, tq = _both(rng.normal(size=(c["H"], c["Sq"], c["Dh"])), dtype)
    jk, tk = _both(rng.normal(size=(c["H"], c["Sk"], c["Dh"])), dtype)
    jv, tv = _both(rng.normal(size=(c["H"], c["Sk"], c["Dh"])), dtype)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"],
              scale=1.0 / c["Dh"] ** 0.5, q_offset=qo)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    kern = _flash_call(jq, jk, jv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(j_ref(jq, jk, jv, **kw)),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got, attention_ref(tq, tk, tv, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 50.0)])
def test_mha_gqa_matches_jax(window, softcap):
    """GQA by head group: query head h reads KV head h // (Hq // Hkv),
    as the JAX wrapper's repeat does."""
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, Dh = 2, 64, 8, 2, 32
    jq, tq = _both(rng.normal(size=(B, S, Hq, Dh)), "f32")
    jk, tk = _both(rng.normal(size=(B, S, Hkv, Dh)), "f32")
    jv, tv = _both(rng.normal(size=(B, S, Hkv, Dh)), "f32")
    got = mha(tq, tk, tv, causal=True, window=window, softcap=softcap)
    want = j_mha(jq, jk, jv, causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("window", [0, 16])
def test_mha_decode_row_at_offset(window):
    """One query row at position q_offset against a longer cache, the
    window (16) excluding early keys, against JAX mha and against the
    last row of the full causal attention."""
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, Dh = 2, 96, 4, 2, 32
    jq, tq = _both(rng.normal(size=(B, S, Hq, Dh)), "f32")
    jk, tk = _both(rng.normal(size=(B, S, Hkv, Dh)), "f32")
    jv, tv = _both(rng.normal(size=(B, S, Hkv, Dh)), "f32")
    kw = dict(causal=True, window=window, softcap=50.0)
    last = mha(tq[:, -1:], tk, tv, q_offset=S - 1, **kw)
    want = j_mha(jq[:, -1:], jk, jv, q_offset=S - 1, **kw)
    np.testing.assert_allclose(_f32(last), _f32(want), rtol=3e-4,
                               atol=3e-4)
    full = mha(tq, tk, tv, **kw)
    np.testing.assert_allclose(_f32(last[:, 0]), _f32(full[:, -1]),
                               rtol=3e-4, atol=3e-4)


def test_row_without_live_key_averages_every_key():
    """A query past every key's window sees no live key: masked scores
    are -1e30, not -inf, so the row is the mean of v over all keys, as
    in the JAX reference."""
    rng = np.random.default_rng(2)
    jq, tq = _both(rng.normal(size=(1, 3, 16)), "f32")
    jk, tk = _both(rng.normal(size=(1, 20, 16)), "f32")
    jv, tv = _both(rng.normal(size=(1, 20, 16)), "f32")
    kw = dict(causal=True, window=4, softcap=0.0, scale=0.25, q_offset=30)
    got = flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(j_ref(jq, jk, jv, **kw)),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_f32(got[0, 0]), _f32(tv[0].mean(0)),
                               rtol=1e-5, atol=1e-6)


def test_cpu_call_counts_no_launch():
    q = torch.zeros(1, 4, 2, 8)
    mha(q, q, q)
    flash_attention(q[0], q[0], q[0])
    assert tkernels.launches()["flash_attention"] == 0


def test_shapes_are_checked():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError):
        mha(q, torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
