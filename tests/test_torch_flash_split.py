"""The decode route's split over the cache and the prefill route's numerics,
on the CPU.

``attention_split_ref`` (the split-and-combine arithmetic of the decode
kernel in plain torch) is held against the JAX package's ``mha`` (its
Pallas kernel in interpret mode, as ``tests/test_torch_flash_attention.py``
runs it) at f32 3e-4, the JAX package's own tolerance: the chunks add
their online softmax in another order than one softmax over every key.
A row with no live key is held against the JAX package's jnp reference
instead: the Pallas kernel masks the keys it pads Sk with at -1e30 too,
so such a row averages v over the padded length, where the reference,
the port and its kernels average over the Sk keys.
The split plan, the hazards of the combine (chunks without keys, wholly
masked chunks) and the route of a call are checked exactly.  The numerics
test pins why the bf16 prefill kernel splits P into two bf16 halves."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import mha as j_mha
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch import kernels as tkernels
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (FLASH_SERVE_TOL,
                                                     attention_ref,
                                                     attention_split_ref,
                                                     live_range, mha_ref,
                                                     split_plan)

# decode shapes (one row per query head, GQA 2) and the chunks they make:
# "live" the default plan over the live keys; "masked" every key, so the
# window leaves the first chunks wholly masked; "past Sk" chunks beyond
# the cache; "no live key" a row past every key's window (every chunk
# masked: the mean of v); 96 keys in 7 chunks of 14 leave a ragged 12
CASES = {
    "live": dict(Sk=96, q_offset=95, window=0, softcap=50.0, bounds=None),
    "masked": dict(Sk=96, q_offset=95, window=16, softcap=0.0,
                   bounds=(0, 96)),
    "past Sk": dict(Sk=96, q_offset=95, window=0, softcap=0.0,
                    bounds=(0, 150)),
    "no live key": dict(Sk=20, q_offset=30, window=4, softcap=0.0,
                        bounds=None),
}


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _j_ref_mha(q, k, v, **kw):
    """JAX's jnp reference with the JAX wrapper's head repeat and fold."""
    B, Sq, Hq, D = q.shape
    rep = Hq // k.shape[2]
    fold = [x.repeat(rep if x is not q else 1, axis=2).transpose(0, 2, 1, 3)
            .reshape(B * Hq, -1, D) for x in (q, k, v)]
    o = j_ref(*map(jnp.asarray, fold), scale=D ** -0.5, **kw)
    return np.asarray(o).reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)


def _inputs(seed, B, Sq, Hq, Hkv, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_split_ref_matches_jax_mha(case, splits):
    c = CASES[case]
    q, k, v = _inputs(splits, 2, 1, 4, 2, c["Sk"], 32)
    kw = dict(causal=True, window=c["window"], softcap=c["softcap"],
              q_offset=c["q_offset"])
    got = mha_ref(*map(torch.from_numpy, (q, k, v)), splits=splits,
                  bounds=c["bounds"], **kw)
    if case == "no live key":
        want = _j_ref_mha(q, k, v, **kw)
    else:
        want = j_mha(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    if case == "no live key":  # every key masked: v averaged over all
        mean = np.repeat(v.mean(1), 2, axis=1)[:, None]
        np.testing.assert_allclose(got.numpy(), mean, rtol=1e-5, atol=1e-6)


def test_split_hazards():
    """A chunk without keys gets weight 0 (no exp(-inf - -inf)); a wholly
    masked chunk gets weight 0 beside a live one; a dropped chunk moves
    the output (the planted fault chip_smoke.py must reject)."""
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
               for x in _inputs(5, 1, 1, 2, 2, 64, 16))
    kw = dict(causal=True, window=8, scale=0.25, q_offset=63)
    want = attention_ref(q, k, v, **kw)
    for bounds in ((0, 64), (0, 200), (56, 64)):
        got = attention_split_ref(q, k, v, 4, bounds=bounds, **kw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # chunk 3 of (0, 64) holds the 8 live keys 56..63; chunk 0 is masked
    dropped = attention_split_ref(q, k, v, 4, bounds=(0, 64), drop=3, **kw)
    assert (dropped - want).abs().max() > 0.1
    same = attention_split_ref(q, k, v, 4, bounds=(0, 64), drop=0, **kw)
    torch.testing.assert_close(same, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [0, 4096])
def test_split_plan_fills_the_card(window):
    """gemma2-2b's decode (4 requests x 4 KV heads, position 8,200 of an
    8,224-row cache): at least twice 132 SMs' worth of blocks, chunks that
    tile the live keys with none empty."""
    kb, ke, chunk, splits = split_plan(1, 8224, True, window, 8200, 16)
    assert (kb, ke) == ((0, 8201) if window == 0 else (4105, 8201))
    assert 16 * splits >= 2 * 132
    assert (splits - 1) * chunk < ke - kb <= splits * chunk
    assert split_plan(1, 20, True, 4, 30, 1)[:2] == (0, 20)  # no live key
    assert split_plan(1, 5, True, 0, 4, 16) == (0, 5, 5, 1)


def test_live_range():
    assert live_range(3, 20, True, 4, 30) == (0, 20)
    assert live_range(4, 100, True, 10, 50) == (41, 54)
    assert live_range(4, 100, False, 0, 50) == (0, 100)


def test_route():
    bf16, f32 = torch.bfloat16, torch.float32
    assert ops.route(bf16, 2, 256) == "decode"
    assert ops.route(f32, 8, 16) == "decode"
    assert ops.route(bf16, 9, 256) == "prefill"
    assert ops.route(f32, 16384, 256) == "prefill_f32"
    for bad in ((bf16, 16384, 96), (bf16, 2, 12), (f32, 4, 258),
                (torch.float16, 64, 64)):
        with pytest.raises(ValueError):
            ops.route(*bad)


def _p_split_attention(q, k, v, scale, split: bool):
    """Plain attention in f32 whose P.V takes P as bf16, one copy or two
    halves p_hi + p_lo as the bf16 prefill kernel does; denominator in
    f32."""
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    live = torch.arange(Sk)[None] <= torch.arange(Sk - Sq, Sk)[:, None]
    s = torch.where(live, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    pv = hi @ v.float()
    if split:
        pv = pv + (p - hi).bfloat16().float() @ v.float()
    return (pv / p.sum(-1, keepdim=True)).bfloat16()


def test_p_split_meets_the_serving_tolerance():
    """At D = 256 over 4,096 keys, P as p_hi + p_lo in bf16 stays within
    FLASH_SERVE_TOL of attention_ref in bf16; a single bf16 copy of P
    does not (its 2^-8 relative error per term misses atol 1e-5 where the
    output is near 0)."""
    rng = np.random.default_rng(0)
    H, Sq, Sk, D = 2, 64, 4096, 256
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .bfloat16() for s in ((H, Sq, D), (H, Sk, D), (H, Sk, D)))
    want = attention_ref(q, k, v, scale=D ** -0.5, q_offset=Sk - Sq)
    rtol, atol = FLASH_SERVE_TOL["rtol"], FLASH_SERVE_TOL["atol"]
    assert (rtol, atol) == (8e-3, 1e-5)

    def share(got):
        d = (got.float() - want.float()).abs()
        return float((d / (atol + rtol * want.float().abs())).max())

    assert share(_p_split_attention(q, k, v, D ** -0.5, True)) <= 1.0
    assert share(_p_split_attention(q, k, v, D ** -0.5, False)) > 1.0
    assert math.isfinite(share(want))
