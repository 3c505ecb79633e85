"""The four kernel modules of the port, on the CPU (their plain versions),
against the JAX package's kernels run as its own tests run them (Pallas in
interpret mode) and against its jnp references — same regions, loaded
into the port with ``convert``, exact (integer tolerance 0), dtypes
included."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.core import dataflow_index as jdi
from repro.core import delta as jdelta
from repro.kernels.extend.ops import fused_extend as j_fused_extend
from repro.kernels.intersect.ops import signed_member as j_signed_member
from repro.kernels.merge import fold as jfold
from repro.kernels.merge.merge import rank_counts as j_rank_counts
from repro.kernels.merge.ref import rank_ref as j_rank_ref
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.core import csr as tcsr
from repro_torch.kernels.extend.ops import fused_extend
from repro_torch.kernels.intersect.ops import signed_member
from repro_torch.kernels.merge.fold import commit_fold
from repro_torch.kernels.merge.ops import rank_lt_le

from tests.test_torch_csr import same, same_index


def region(rng, n, narrow, nv=40, capacity=None):
    t = rng.integers(0, nv, (max(n, 0), 2)).astype(np.int32)
    return jcsr.build_index(t, (0,), 1, capacity, narrow=narrow)


def queries(rng, B, narrow, nv=45):
    kdt = np.int32 if narrow else np.int64
    qk = rng.integers(0, nv, B).astype(kdt)
    qk[:4] = np.iinfo(kdt).max  # sentinel-padded queries
    qv = rng.integers(0, nv, B).astype(np.int32)
    return (jnp.asarray(qk), jnp.asarray(qv),
            torch.from_numpy(qk), torch.from_numpy(qv))


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("seed", range(3))
def test_signed_member_matches_jax_kernel(narrow, seed):
    rng = np.random.default_rng(seed)
    pos = [region(rng, int(rng.integers(0, 300)), narrow,
                  capacity=int(rng.integers(1, 400))) for _ in range(3)]
    neg = [region(rng, int(rng.integers(0, 60)), narrow) for _ in range(2)]
    jqk, jqv, tqk, tqv = queries(rng, 300, narrow)
    tvi = convert.versioned_of(jdi.VersionedIndex(tuple(pos), tuple(neg)),
                               device="cpu")
    tpos, tneg = list(tvi.pos), list(tvi.neg)
    for p, n in ((pos, neg), ((), neg), (pos, ())):
        tp = tpos if p else ()
        tn = tneg if n else ()
        jw = j_signed_member(tuple(p), tuple(n), jqk, jqv)
        tw = signed_member(tp, tn, tqk, tqv)
        for a, b in zip(tw, jw):
            same(a, b)


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("n", [0, 1, 150, 300])
def test_rank_matches_jax_kernel_and_ref(narrow, n):
    rng = np.random.default_rng(7 + n)
    j = region(rng, n, narrow, capacity=n + 40)
    t = convert.index_of(j, device="cpu")
    jqk, jqv, tqk, tqv = queries(rng, 97, narrow, nv=60)
    lt, le = rank_lt_le(t.key, t.val, t.n, tqk, tqv)
    for got, want in ((lt, 0), (le, 1)):
        same(got, j_rank_counts(j.key, j.val, j.n, jqk, jqv,
                                interpret=True)[want])
        same(got, j_rank_ref(j.key, j.val, j.n, jqk, jqv)[want])


def _fold_case(rng, narrow, packed=False):
    def reg(n, nv):
        if packed:  # the live-set layout: key u<<32|v int64, val 0
            t = rng.integers(0, nv, (n, 2)).astype(np.int32)
            t = np.concatenate([t, np.zeros((n, 1), np.int32)], 1)
            return jcsr.build_index(t, (0, 1), 2, narrow=False)
        return region(rng, n, narrow, nv=nv)
    base = reg(300, 25)
    ci, cd, ui, ud = (reg(int(rng.integers(0, m)), 25)
                      for m in (150, 100, 120, 120))
    return base, ci, cd, ui, ud


@pytest.mark.parametrize("layout", ["i32", "i64", "packed"])
@pytest.mark.parametrize("seed", range(2))
def test_commit_fold_matches_jax_kernel_and_chain(layout, seed):
    rng = np.random.default_rng(20 + seed)
    base, ci, cd, ui, ud = _fold_case(rng, layout == "i32",
                                      packed=layout == "packed")
    lt, le = jcsr.index_ranks(base, jcsr._qcols_of(ud), ud.val)
    j_in_ba = (le > lt).astype(jnp.int32)
    tb, tci, tcd, tui, tud = (convert.index_of(r, device="cpu")
                              for r in (base, ci, cd, ui, ud))
    tlt, tle = tcsr.index_ranks(tb, tud.key, tud.val, plain=True)
    in_ba = (tle > tlt).to(torch.int32)
    same(in_ba, j_in_ba)
    # seed 1 folds into a capacity too small for the union: the overflow
    # drops exactly as the reference's scatters do
    cap = 128 if seed else tcsr.round_capacity(ci.capacity + ui.capacity)
    got = commit_fold(tci, tcd, tui, tud, in_ba, cins_cap=cap, cdel_cap=cap)
    kern = jfold.commit_fold(ci, cd, ui, ud, j_in_ba, cins_cap=cap,
                             cdel_cap=cap, interpret=True)
    chain = jdelta._commit_fold_safe(base, ci, cd, ui, ud, cins_cap=cap,
                                     cdel_cap=cap, sharded=False,
                                     use_kernel=False)
    for g, k, c in zip(got, kern, chain):
        same_index(g, k)
        same_index(g, c)


def _extend_case(rng, narrow, nb):
    pos = [tuple(region(rng, int(rng.integers(1, 250)), narrow)
                 for _ in range(int(rng.integers(1, 4))))
           for _ in range(nb)]
    neg = [tuple(region(rng, int(rng.integers(0, 40)), narrow)
                 for _ in range(int(rng.integers(0, 3))))
           for _ in range(nb)]
    return pos, neg


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("seed", range(3))
def test_fused_extend_matches_jax_kernel(narrow, seed):
    rng = np.random.default_rng(40 + seed)
    nb = 1 + seed
    pos, neg = _extend_case(rng, narrow, nb)
    W, B = 200, 256
    kdt = np.int32 if narrow else np.int64
    qks = [rng.integers(0, 45, W).astype(kdt) for _ in range(nb)]
    wk = rng.integers(0, 3, W).astype(np.int32)
    valid = np.arange(W) < int(rng.integers(1, W))
    want = j_fused_extend(tuple(pos), tuple(neg),
                          tuple(jnp.asarray(q) for q in qks),
                          jnp.asarray(wk), jnp.asarray(valid), B)
    got = fused_extend(
        [[convert.index_of(r, device="cpu") for r in p] for p in pos],
        [[convert.index_of(r, device="cpu") for r in n] for n in neg],
        [torch.from_numpy(q) for q in qks], torch.from_numpy(wk),
        torch.from_numpy(valid), B)
    for g, w in zip(got, want):
        same(g, w)
