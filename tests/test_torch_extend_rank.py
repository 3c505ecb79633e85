"""The fused extension step and merge ranks at their edge inputs, pinned on
the CPU: the port's plain versions against the JAX package's kernels
(Pallas in interpret mode, as its own tests run them) and its jnp
references, exact.  The same cases run at full size on the card, kernel
against plain version, in ``chip_smoke.py`` (``extend_rank_edge_checks``).

Fused extend: resumed cursors (wk > 0), a budget exhausted in the middle
of a row, rows with no extension between live rows, every row invalid, B'
above the total (slots past it clip to W - 1), argmin ties, regions with
n = 0 and n = capacity, and a composite (hi, lo) binding.  Ranks: unsorted
queries, a region holding entries twice against itself, sentinel queries,
queries past either end, a narrow region with int64 queries, n = 0 and n =
capacity, and composite keys."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.kernels.extend.ops import fused_extend as j_fused_extend
from repro.kernels.merge.merge import rank_counts as j_rank_counts
from repro.kernels.merge.ref import rank_ref as j_rank_ref
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.kernels.extend.ops import fused_extend
from repro_torch.kernels.merge.ops import rank_lt_le

from tests.test_torch_csr import same

W, B = 160, 192  # window rows, proposal budget B'
FULL = 256  # live entries == capacity


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


def _region(rows, composite, narrow, capacity=None):
    cols = (0, 1, 2) if composite else (0,)
    return jcsr.build_index(rows, cols, len(cols), capacity, narrow=narrow)


def _rows(rng, n, nv, composite):
    return rng.integers(0, nv, (n, 4 if composite else 2)).astype(np.int32)


def _full_and_empty(rng, composite, narrow, nv):
    """A region whose live count equals its capacity, and one with n = 0
    over the same entries."""
    rows = np.unique(_rows(rng, 8 * FULL, nv, composite), axis=0)[:FULL]
    full = _region(rows, composite, narrow, FULL)
    assert int(full.n) == full.key.shape[0] == FULL
    return full, jcsr.IndexData(full.key, full.val, jnp.int32(0), full.lo)


def _keys(prefix, composite, dtype):
    """Lookup keys of window prefixes [W, 1 or 3]: numpy for both packages."""
    if composite:
        hi, lo = jcsr.pack_key(tuple(prefix[:, c] for c in range(3)))
        return np.asarray(hi).astype(dtype), np.asarray(lo)
    return prefix[:, 0].astype(dtype)


def _case(name, narrow):
    """(pos, neg, keys, wk, valid) of one edge case, JAX regions."""
    rng = np.random.default_rng(10 * EXTEND_CASES.index(name) + narrow)
    kd = np.int32 if narrow else np.int64
    comp = name == "composite"
    nv = 24
    # fixed capacities: cases of one structure share the JAX kernel's
    # compilation
    a = _region(_rows(rng, 600, nv, comp), comp, narrow, 640)
    b = _region(_rows(rng, 90, nv, comp), comp, narrow, 128)
    d = _region(_rows(rng, 40, nv, comp), comp, narrow, 128)
    prefix = rng.integers(0, nv, (W, 3 if comp else 1)).astype(np.int32)
    wk = np.zeros(W, np.int32)
    valid = np.arange(W) < W - 7
    pos, neg = [(a, b), (a,)], [(d,), ()]
    edge = _rows(rng, 300, nv, False)
    e_reg = _region(edge, False, narrow, 384)
    if name == "resumed":
        wk = rng.integers(0, 6, W).astype(np.int32)
    elif name == "zero rows":  # every third row's key has no entry
        prefix[::3] = nv + 5
    elif name == "all invalid":
        valid = np.zeros(W, bool)
    elif name == "under budget":  # three live rows propose fewer than B'
        valid = np.arange(W) < 3
    elif name == "ties":  # two equal bindings: argmin keeps the first
        pos, neg = [(a, b), (a, b)], [(d,), (d,)]
    elif name == "n=0 and n=cap":
        full, empty = _full_and_empty(rng, False, narrow, 2 * nv)
        pos, neg = [(full, empty, a), (empty, full)], [(empty,), (empty,)]
    elif name == "composite":  # a 3-column binding beside a 1-word one
        pos, neg = [(a, b), (e_reg,)], [(d,), ()]
    keys = [_keys(prefix, comp, kd),
            _keys(prefix[:, :1] if comp else prefix, False, kd)]
    return pos, neg, keys, wk, valid


EXTEND_CASES = ["resumed", "mid-row budget", "zero rows", "all invalid",
                "under budget", "ties", "n=0 and n=cap", "composite"]


# every case with int32 keys; the int64 layout where the keys' width
# matters (the composite hi word, a budget cut mid-row)
@pytest.mark.parametrize("name,narrow", [(c, True) for c in EXTEND_CASES] + [
    ("composite", False), ("mid-row budget", False)])
def test_fused_extend_edge_inputs_match_jax_kernel(name, narrow):
    pos, neg, keys, wk, valid = _case(name, narrow)

    def jk(k):
        return (jnp.asarray(k[0]), jnp.asarray(k[1])) \
            if isinstance(k, tuple) else jnp.asarray(k)

    def tk(k):
        return (torch.from_numpy(k[0]), torch.from_numpy(k[1])) \
            if isinstance(k, tuple) else torch.from_numpy(k)

    want = j_fused_extend(tuple(pos), tuple(neg), tuple(jk(k) for k in keys),
                          jnp.asarray(wk), jnp.asarray(valid), B)
    got = fused_extend(
        [[convert.index_of(r, device="cpu") for r in p] for p in pos],
        [[convert.index_of(r, device="cpu") for r in n] for n in neg],
        [tk(k) for k in keys], torch.from_numpy(wk),
        torch.from_numpy(valid), B)
    for g, w in zip(got, want):
        same(g, w)
    cand, row, alive, allowed, consumed, counters = (np.asarray(w)
                                                     for w in want)
    proposed = int(counters[0])
    # the case shows what it is named for
    if name == "all invalid":
        assert proposed == 0 and not allowed.any() and (row == W - 1).all()
    elif name == "under budget":
        assert 0 < proposed < B and (row[proposed:] == W - 1).all()
    elif name == "mid-row budget":
        assert proposed == B
        assert (valid & ~consumed & (allowed > 0)).sum() == 1
    elif name == "zero rows":
        live = np.flatnonzero(allowed > 0)
        assert live.size > 1 and (allowed[live[0]:live[-1]] == 0).any()
    elif name == "resumed":
        assert (wk[row[:proposed]] > 0).any()
    if name not in ("all invalid",):
        assert alive.any()


def _rank_region(rng, composite, narrow, kind):
    nv = 30
    if kind == "n=cap":
        return _full_and_empty(rng, composite, narrow, nv)[0]
    if kind == "n=0":
        return _full_and_empty(rng, composite, narrow, nv)[1]
    r = _region(_rows(rng, 400, nv, composite), composite, narrow)
    if kind != "twice":
        return r
    n = int(r.n)
    cap = 2 * n + 128
    pad = cap - 2 * n
    key = np.concatenate([np.repeat(np.asarray(r.key)[:n], 2), np.full(
        pad, np.iinfo(np.asarray(r.key).dtype).max)])
    val = np.concatenate([np.repeat(np.asarray(r.val)[:n], 2),
                          np.full(pad, 2**31 - 1, np.int32)])
    lo = None if r.lo is None else jnp.asarray(np.concatenate(
        [np.repeat(np.asarray(r.lo)[:n], 2), np.full(pad, 2**63 - 1)]))
    return jcsr.IndexData(jnp.asarray(key), jnp.asarray(val),
                          jnp.int32(2 * n), lo)


RANK_CASES = ["unsorted", "twice", "sentinels and ends", "narrow int64",
              "n=0", "n=cap"]


@pytest.mark.parametrize("composite", [False, True], ids=["1word", "lex"])
@pytest.mark.parametrize("name", RANK_CASES)
def test_rank_edge_inputs_match_jax(name, composite):
    """The port's ranks against the JAX package's jnp reference and, for
    1-word keys, its Pallas kernel.  The port follows the jnp reference
    where the Pallas kernels do not, a reference-side quirk: they count
    every segment before the query's as live, so a query above every live
    entry with a segment of padding or dead entries below it ranks past n
    (the composite kernel on sentinel queries; the 1-word one on the
    padding of the region held twice, and on n = 0 over real entries)."""
    rng = np.random.default_rng(len(name) + 17 * composite)
    narrow = name != "twice"
    r = _rank_region(rng, composite, narrow,
                     name if name in ("n=0", "n=cap", "twice") else "")
    if name == "twice":  # the region against itself
        qk, qv = np.array(r.key), np.array(r.val)
        ql = None if r.lo is None else np.array(r.lo)
    else:
        q = _rows(rng, 200, 34, composite)
        if composite:
            qk, ql = (np.asarray(x) for x in jcsr.pack_key(
                tuple(q[:, c] for c in range(3))))
        else:
            qk, ql = q[:, 0].astype(np.int64), None
        qv = q[:, -1]
        if name != "unsorted":  # sorted queries, as every caller passes
            order = np.lexsort((qv,) + ((ql,) if composite else ()) + (qk,))
            qk, qv = qk[order], qv[order]
            ql = None if ql is None else ql[order]
    wide = composite or name == "narrow int64" or not narrow
    kd = np.int64 if wide else np.int32
    if name == "narrow int64":  # hi words past int32 too: promoted, kept
        qk = np.concatenate([qk, [2**31, 2**40]])
        qv = np.concatenate([qv, [0, 5]])
        if composite:
            ql = np.concatenate([ql, [0, 0]])
    if name == "sentinels and ends":
        kmax, kmin = np.iinfo(kd).max, np.iinfo(kd).min
        i32max, i64max = 2**31 - 1, 2**63 - 1
        top = int(np.asarray(r.key)[int(r.n) - 1])
        qk = np.concatenate([[kmin, -1, 0], qk, [top, top + 1, kmax, kmax]])
        qv = np.concatenate([[-2**31, 0, -1], qv, [i32max, 0, 0, i32max]])
        if composite:
            ql = np.concatenate([[-2**63, 0, 0], ql,
                                 [i64max, 0, i64max, i64max]])
    qk = qk.astype(kd)
    t = convert.index_of(r, device="cpu")
    lt, le = rank_lt_le(t.key, t.val, t.n, torch.from_numpy(qk),
                        torch.from_numpy(qv), lo=t.lo,
                        qlo=None if ql is None else torch.from_numpy(ql))
    jq = (jnp.asarray(qk), jnp.asarray(qv))
    lo_kw = {} if ql is None else dict(lo=r.lo, qlo=jnp.asarray(ql))
    ref = j_rank_ref(r.key, r.val, r.n, *jq, **lo_kw)
    same(lt, ref[0])
    same(le, ref[1])
    if not composite and name not in ("twice", "n=0"):
        kern = j_rank_counts(r.key, r.val, r.n, *jq, interpret=True)
        same(lt, kern[0])
        same(le, kern[1])
    n = int(r.n)
    assert int(lt.max()) <= n and int(le.min()) >= 0
    if name == "twice":
        assert int((le - lt).max()) == 2
    if name == "sentinels and ends":
        assert int(lt[0]) == 0 and int(lt[-1]) == int(le[-1]) == n
    if name == "n=0":
        assert not lt.any() and not le.any()
