"""Sorted indices: the port's csr equals the JAX package's bit for bit —
build (narrow and wide keys, full capacity and padding), searches, ranks,
merge and select, dtypes included.  Inputs come from numpy seeds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro_torch import convert
from repro_torch.core import csr as tcsr


def same(t, j):
    """A port tensor equals a JAX array: dtype, shape and bits."""
    a, b = t.cpu().numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def same_index(t, j):
    same(t.key, j.key)
    same(t.val, j.val)
    assert int(t.n) == int(j.n)
    assert t.n.dtype == torch.int32 and t.n.dim() == 0


def pair(rng, n, narrow, nv=50, capacity=None, key_cols=(0,)):
    tup = rng.integers(0, nv, (n, 3)).astype(np.int32)
    ext = 2 if len(key_cols) == 2 else 1
    return (jcsr.build_index(tup, key_cols, ext, capacity, narrow=narrow),
            tcsr.build_index(tup, key_cols, ext, capacity, narrow=narrow,
                             device="cpu"))


WIDTHS = [True, False, None]


@pytest.mark.parametrize("narrow", WIDTHS, ids=["i32", "i64", "auto"])
@pytest.mark.parametrize("n", [0, 1, 127, 128, 300])
def test_build_index_matches(narrow, n):
    rng = np.random.default_rng(n)
    for kc in ((0,), (0, 1)):
        j, t = pair(rng, n, narrow, key_cols=kc)
        same_index(t, j)
    j, t = pair(rng, n, narrow, capacity=1000)  # padding past the live set
    same_index(t, j)
    je, te = jcsr.empty_index(300, narrow=bool(narrow)), \
        tcsr.empty_index(300, narrow=bool(narrow), device="cpu")
    same_index(te, je)
    assert tcsr.pow2_capacity(n) == jcsr.pow2_capacity(n)
    assert tcsr.round_capacity(n) == jcsr.round_capacity(n)


def test_pack_and_unpack_match():
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, 2**31 - 1, 40).astype(np.int32)
            for _ in range(4)]
    for k in (1, 2, 3, 4):
        j, t = jcsr.pack_key(cols[:k]), tcsr.pack_key(cols[:k])
        if k <= 2:
            np.testing.assert_array_equal(np.asarray(j), t)
            same(tcsr.pack_key([torch.from_numpy(c) for c in cols[:k]]),
                 jcsr.pack_key([jnp.asarray(c) for c in cols[:k]]))
        else:
            for a, b in zip(j, t):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jcsr.unpack_key(j, k),
                                      tcsr.unpack_key(t, k))


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("n", [0, 5, 200])
def test_searches_and_ranks_match(narrow, n):
    rng = np.random.default_rng(10 + n)
    j, t = pair(rng, n, narrow, capacity=n + 70)
    B = 333
    qk_np = rng.integers(0, 55, B).astype(np.int64)
    qk_np[:7] = np.iinfo(np.int32 if narrow else np.int64).max  # sentinels
    qv_np = rng.integers(0, 55, B).astype(np.int32)
    kdt = np.int32 if narrow else np.int64
    jqk, tqk = jnp.asarray(qk_np.astype(kdt)), \
        torch.from_numpy(qk_np.astype(kdt))
    jqv, tqv = jnp.asarray(qv_np), torch.from_numpy(qv_np)
    for a, b in zip(tcsr.index_range(t, tqk), jcsr.index_range(j, jqk)):
        same(a, b)
    same(tcsr.index_member(t, tqk, tqv), jcsr.index_member(j, jqk, jqv))
    for side in ("left", "right"):
        same(tcsr.lex_searchsorted(t.key, t.val, t.n, tqk, tqv, side),
             jcsr.lex_searchsorted(j.key, j.val, j.n, jqk, jqv, side))
    for a, b in zip(tcsr.index_ranks(t, tqk, tqv),
                    jcsr.index_ranks(j, jqk, jqv)):
        same(a, b)


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_and_select_match(narrow, seed):
    rng = np.random.default_rng(100 + seed)
    ja, ta = pair(rng, int(rng.integers(0, 150)), narrow, nv=20)
    jb, tb = pair(rng, int(rng.integers(0, 150)), narrow, nv=20)
    for cap in (tcsr.round_capacity(ta.capacity + tb.capacity), 128):
        same_index(tcsr._merge_core(ta, tb, cap),
                   jcsr._merge_core(ja, jb, cap))
    for keep in (False, True):
        same_index(tcsr._select_core(ta, tb, ta.capacity, keep),
                   jcsr._select_core(ja, jb, ja.capacity, keep))


def test_convert_round_trip():
    rng = np.random.default_rng(3)
    j, _ = pair(rng, 90, None)
    t = convert.index_of(j, device="cpu")
    same_index(t, j)
    k, v, n = convert.to_numpy(t)
    np.testing.assert_array_equal(k, np.asarray(j.key))
    np.testing.assert_array_equal(v, np.asarray(j.val))
    assert n == int(j.n)
