"""The inputs that the card's checks of the membership and segment-sum
kernels use at their edges, pinned on the CPU: the port's plain versions
against the JAX package's kernels (Pallas in interpret mode, as its own
tests run them) and its jnp references.

Membership is compared exactly: one region longer than 33^2 entries (a
33-ary search needs three levels there), a key whose run of entries is
longer than 32 with distinct vals, regions with n = 0 and n = capacity,
all-sentinel queries, and queries below the first entry and above the
last, 1-word and composite (hi, lo).  Segment sums within the JAX
package's tolerances (``_tol``) on a hub of 90 % of 20,000 rows, all rows
in one segment, and empty segments between the hub and the rest; their
values lie on a 1/16 grid, so every order of f32 adds gives the same sum.
And the descriptor cache key of the CUDA launch path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.core import dataflow_index as jdi
from repro.kernels.intersect.ops import member as j_member
from repro.kernels.intersect.ops import signed_member as j_signed_member
from repro.kernels.segment_ops.ops import segment_sum as j_segment_sum
from repro.kernels.segment_ops.ref import segment_sum_ref as j_segsum_ref
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.core import csr as tcsr
from repro_torch.kernels import _build
from repro_torch.kernels.intersect.ops import member, signed_member
from repro_torch.kernels.segment_ops import segment_sum

from tests.test_torch_csr import same
from tests.test_torch_segment_ops import _tol

RUN = 300  # entries of one key, distinct vals
BIG = 2000  # live entries of the large region (> 33^2 = 1089)
FULL = 1024  # live entries == capacity


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _rows(rng, composite, n, nv):
    return rng.integers(0, nv, (n, 4 if composite else 2)).astype(np.int32)


def _build_j(rows, composite, narrow, capacity=None):
    cols = (0, 1, 2) if composite else (0,)
    return jcsr.build_index(rows, cols, len(cols), capacity, narrow=narrow)


def _edge_regions(rng, composite, narrow):
    """(big, run, full, empty) JAX regions and the rows of the first three."""
    nv = 12 if composite else 60
    big_rows = np.unique(_rows(rng, composite, 3 * BIG, nv), axis=0)[:BIG]
    run_rows = _rows(rng, composite, 2 * RUN, nv)
    run_rows[:RUN, :-1] = run_rows[0, :-1]
    run_rows[:RUN, -1] = np.arange(RUN)
    full_rows = np.unique(_rows(rng, composite, 4 * FULL, 2 * nv),
                          axis=0)[:FULL]
    big = _build_j(big_rows, composite, narrow)
    run = _build_j(run_rows, composite, narrow)
    full = _build_j(full_rows, composite, narrow, FULL)
    assert int(big.n) == BIG and int(full.n) == full.key.shape[0] == FULL
    empty = jcsr.IndexData(run.key, run.val, jnp.int32(0), run.lo)
    return (big, run, full, empty), (big_rows, run_rows, full_rows)


def _edge_queries(rng, regions, rows, composite):
    """Live rows of each region, the run's key past its vals, random rows,
    all-sentinel queries, and queries below the first / above the last
    entry; (qk, ql or None, qv) numpy, keys in the regions' dtype."""
    big, run, full, _ = regions
    kd = np.asarray(big.key).dtype
    q = [r[rng.integers(0, r.shape[0], 64)] for r in rows]
    past = rows[1][:40].copy()
    past[:, -1] = RUN + np.arange(40)
    q = np.concatenate(q + [past, _rows(rng, composite, 64, 70)])
    if composite:
        qk, ql = jcsr.pack_key(tuple(q[:, c] for c in range(3)))
        qk, ql = np.asarray(qk), np.asarray(ql)
    else:
        qk, ql = q[:, 0].astype(np.int64), None
    qv = q[:, -1].astype(np.int32)
    top = int(np.asarray(big.key)[int(big.n) - 1])
    imax, imin = np.iinfo(kd).max, np.iinfo(kd).min
    lmax, lmin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    sk = np.array([imax] * 10 + [imin, -1, top + 1, top])
    sv = np.array([2**31 - 1] * 9 + [0, -2**31, 0, 0, 2**31 - 1], np.int32)
    qk = np.concatenate([qk, sk]).astype(kd)
    qv = np.concatenate([qv, sv])
    if composite:
        ql = np.concatenate([ql, [lmax] * 9 + [0, lmin, 0, 0, lmax]])
        ql = ql.astype(np.int64)
    return qk, ql, qv


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("composite", [False, True], ids=["1word", "lex"])
def test_signed_member_edge_inputs_match_jax_kernel(composite, narrow):
    rng = np.random.default_rng(41 + 2 * composite + narrow)
    regions, rows = _edge_regions(rng, composite, narrow)
    qk, ql, qv = _edge_queries(rng, regions, rows, composite)
    jq = jnp.asarray(qk) if ql is None else (jnp.asarray(qk),
                                             jnp.asarray(ql))
    tq = torch.from_numpy(qk) if ql is None else (torch.from_numpy(qk),
                                                  torch.from_numpy(ql))
    big, run, full, empty = regions
    pos, neg = (big, run, full), (empty, run)
    tvi = convert.versioned_of(jdi.VersionedIndex(pos, neg), device="cpu")
    jw = j_signed_member(pos, neg, jq, jnp.asarray(qv))
    tw = signed_member(tvi.pos, tvi.neg, tq, torch.from_numpy(qv))
    for a, b in zip(tw, jw):
        same(a, b)
    wpos, wneg = (np.asarray(w) for w in jw)
    assert wpos.max() >= 2 and wneg.any() and not wpos[-14:].any()


@pytest.mark.parametrize("narrow", [True, False], ids=["i32", "i64"])
@pytest.mark.parametrize("composite", [False, True], ids=["1word", "lex"])
def test_member_edge_inputs_match_jax_kernel(composite, narrow):
    rng = np.random.default_rng(43 + 2 * composite + narrow)
    regions, rows = _edge_regions(rng, composite, narrow)
    qk, ql, qv = _edge_queries(rng, regions, rows, composite)
    for idx in regions:
        kern = np.asarray(j_member(
            idx.key, idx.val, idx.n, jnp.asarray(qk), jnp.asarray(qv),
            **({} if ql is None else dict(los=idx.lo, ql=jnp.asarray(ql)))))
        t = convert.index_of(idx, device="cpu")
        got = member(t.key, t.val, t.n, torch.from_numpy(qk),
                     torch.from_numpy(qv), los=t.lo,
                     ql=None if ql is None else torch.from_numpy(ql))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), kern)
        assert kern.any() == (int(idx.n) > 0)


def _grid_values(rng, E, D):
    """Values on a 1/16 grid in [-4, 4]: any order of f32 adds of 20,000
    of them is exact, so the JAX kernel's one-hot matmul and the plain
    version's index_add_ can be held to the JAX package's tolerance."""
    return (rng.integers(-64, 65, (E, D)) / 16).astype(np.float32)


@pytest.mark.parametrize("case", ["hub", "one segment", "gap"])
def test_segment_sum_hub_inputs_match_jax_kernel(case):
    """A hub of >= 90 % of E = 20,000 sorted rows (its tile partials span
    the tree's second level), all rows in one segment, and a hub followed
    by empty segments before the rest; ids NS and above dropped."""
    rng = np.random.default_rng(7)
    E, D, NS = 20_000, 6, 700
    hub = int(0.92 * E)
    if case == "hub":
        seg = np.concatenate([np.zeros(hub), rng.integers(1, NS, E - hub)])
    elif case == "one segment":
        seg = np.full(E, 3)
    else:
        seg = np.concatenate([np.full(hub, 2), rng.integers(400, NS + 20,
                                                            E - hub)])
    seg = np.sort(seg).astype(np.int32)
    data = _grid_values(rng, E, D)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), NS,
                      is_sorted=True)
    kern = np.asarray(j_segment_sum(jnp.asarray(data), jnp.asarray(seg), NS,
                                    is_sorted=True))
    ref = np.asarray(j_segsum_ref(jnp.asarray(data), jnp.asarray(seg), NS))
    np.testing.assert_allclose(got.numpy(), kern, **_tol(np.float32))
    np.testing.assert_allclose(got.numpy(), ref, **_tol(np.float32))
    present = np.zeros(NS, bool)
    present[seg[seg < NS]] = True
    assert not got.numpy()[~present].any()
    assert (~present).any()


def _region(n=300, narrow=True, composite=False, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 50, (n, 4 if composite else 2)).astype(np.int32)
    cols = (0, 1, 2) if composite else (0,)
    return tcsr.build_index(rows, cols, len(cols), narrow=narrow,
                            device="cpu")


def test_descriptor_key_changes_with_every_word():
    """The cache key of a launch's region descriptor changes whenever a
    word of the descriptor would (a pointer, the capacity, the key width,
    the lo word) or a check could fail (a dtype, contiguity); equal
    regions give equal keys."""
    a, b = _region(seed=1), _region(seed=2)
    c = _region(composite=True, seed=3)
    base = _build.desc_key((a, b))
    assert base == _build.desc_key((tcsr.IndexData(a.key, a.val, a.n), b))
    variants = {
        "key pointer": (tcsr.IndexData(a.key.clone(), a.val, a.n), b),
        "val pointer": (tcsr.IndexData(a.key, a.val.clone(), a.n), b),
        "n pointer": (tcsr.IndexData(a.key, a.val, a.n.clone()), b),
        "capacity": (tcsr.IndexData(a.key[:-128], a.val[:-128], a.n), b),
        "key width": (tcsr.IndexData(a.key.to(torch.int64), a.val, a.n), b),
        "val dtype": (tcsr.IndexData(a.key, a.val.to(torch.int64), a.n), b),
        "n dtype": (tcsr.IndexData(a.key, a.val, a.n.to(torch.int64)), b),
        "second region": (a, c),
        "order": (b, a),
        "count": (a,),
        "lo pointer": (a, tcsr.IndexData(c.key, c.val, c.n, c.lo.clone())),
    }
    keys = {name: _build.desc_key(regs) for name, regs in variants.items()}
    for name, key in keys.items():
        assert key != base, name
    assert len(set(keys.values())) == len(keys)
    # one address, one length, one dtype: only contiguity tells them apart
    wide = torch.stack([a.key, a.key], 1).reshape(-1)
    dense, strided = wide[:a.capacity], wide[::2]
    assert dense.data_ptr() == strided.data_ptr()
    assert dense.shape == strided.shape and not strided.is_contiguous()
    assert _build.desc_key((tcsr.IndexData(dense, a.val, a.n),)) != \
        _build.desc_key((tcsr.IndexData(strided, a.val, a.n),))
    with_lo = _build.desc_key((a, c))
    assert with_lo != _build.desc_key(
        (a, tcsr.IndexData(c.key, c.val, c.n, None)))


def test_descriptor_words_and_cache(monkeypatch):
    """The packed words of a descriptor; a hit returns the cached bytes;
    a region that fails a check raises on every call, never cached."""
    monkeypatch.setattr(_build, "require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "_DESCS", {})
    a, c = _region(narrow=False, seed=4), _region(composite=True, seed=5)
    for regs in ((a,), (a, c)):
        got = _build.region_desc(regs)
        words = np.frombuffer(got, "<i8").tolist()
        want = []
        for r in regs:
            want += [r.key.data_ptr(), r.val.data_ptr(), r.n.data_ptr(),
                     r.key.shape[0], int(r.key.dtype == torch.int64),
                     0 if r.lo is None else r.lo.data_ptr()]
        assert words == want
        assert _build.region_desc(regs) is got
    bad = tcsr.IndexData(a.key, a.val.to(torch.int64), a.n)
    for _ in range(2):
        with pytest.raises(ValueError, match="int32 val"):
            _build.region_desc((bad,))
    assert len(_build._DESCS) == 2


def test_descriptor_of_cpu_regions_raises():
    """Without the card the launch path's checks raise, on every call."""
    a = _region()
    for _ in range(2):
        with pytest.raises(ValueError, match="CPU/CUDA"):
            _build.region_desc((a,))
