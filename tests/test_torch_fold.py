"""The commit fold's two forms in the port (plain versions on the CPU)
against the JAX package at the fold's edge inputs, exact (integer
tolerance 0, dtypes, padding and the composite lo word included):

* the ``in_ba`` form against the Pallas fold run as the JAX package's own
  tests run it (interpret mode), with ``in_ba`` from the JAX rank search;
* the ``base`` form, which probes base itself, against the JAX store's
  fold chain (``delta._commit_fold_safe`` with ``use_kernel=False``), and
  against the ``in_ba`` form of the same inputs;

over 1-word int32 and int64 keys, the live set's packed (u << 32 | v)
keys and composite ``tri`` rows; and the argument rule (exactly one of
``in_ba`` and ``base``).  Capacities are the same in every case, so that
the JAX compiles are shared between them."""
import jax
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import delta as jdelta
from repro.kernels.merge import fold as jfold
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.core import csr as tcsr
from repro_torch.kernels.merge.fold import base_bits, commit_fold

from tests.test_torch_csr import same

# layout -> (row columns, key columns, narrow hi word)
LAYOUTS = {"i32": (2, (0,), True), "i64": (2, (0,), False),
           "packed": (3, (0, 1), False), "tri": (4, (0, 1, 2), False)}
CAP_BASE, CAP = 256, 128  # base; the other regions and both outputs
CASES = ("mixed", "udel_empty", "n_is_cap", "all_cins_deleted",
         "uins_in_cins", "udel_not_in_base", "out_exactly_full",
         "overflow")


def same_index(t, j):
    """A port region equals a JAX one: key, lo, val and n, dtypes too."""
    same(t.key, j.key)
    same(t.val, j.val)
    assert int(t.n) == int(j.n)
    assert t.n.dtype == torch.int32 and t.n.dim() == 0
    assert (t.lo is None) == (j.lo is None)
    if t.lo is not None:
        same(t.lo, j.lo)


def fold_case(layout: str, case: str, seed: int = 0):
    """(base, cins, cdel, uins, udel) as (JAX, port) pairs and the
    outputs' capacity of one edge input.  Rows come from one pool of
    distinct rows, cut so that the regions overlap as each case needs; the
    live set's layouts (``packed``, ``tri``) key on every column with val
    0."""
    ncol, key_pos, narrow = LAYOUTS[layout]
    ar = ncol - 1 if layout in ("packed", "tri") else ncol
    rng = np.random.default_rng(seed + 100 * CASES.index(case))
    nv = 40 if ar == 2 else 14

    def uniq(r, n):
        r = np.unique(r, axis=0)
        return r[rng.permutation(r.shape[0])[:n]]

    pool = uniq(rng.integers(0, nv, (4000, ar)).astype(np.int32), 2000)
    base = pool[:100]
    ci, cd = uniq(pool[80:300], 50), uniq(base, 30)
    ui = uniq(np.concatenate([pool[250:300], ci[:10]]), 40)
    ud = uniq(np.concatenate([base[:20], pool[1000:1010], ci[:10]]), 40)
    if case == "udel_empty":
        ud = ud[:0]
    elif case == "n_is_cap":  # both outputs overflow too
        base, ci, cd = pool[:CAP_BASE], pool[300:300 + CAP], pool[:CAP]
        ui = pool[200:200 + CAP]  # 28 of its rows inside cins
        ud = np.concatenate([pool[:CAP // 2], pool[300:300 + CAP // 2]])
    elif case == "all_cins_deleted":
        ud = uniq(np.concatenate([ci, base[:8]]), CAP)
    elif case == "uins_in_cins":
        ui = ci[:40]
    elif case == "udel_not_in_base":
        ud = pool[1200:1240]
    elif case == "out_exactly_full":  # the union fills cins' exactly
        ci, ui, ud = pool[300:364], pool[400:464], ud[:0]
    elif case == "overflow":  # the writes past cins' capacity drop
        ci, ui = pool[300:400], pool[400:500]

    def build(r, capacity):
        if ncol > ar:  # the live set: a zero ext column
            r = np.concatenate([r, np.zeros((r.shape[0], 1), np.int32)], 1)
        j = jcsr.build_index(r, key_pos, ncol - 1, capacity, narrow=narrow)
        return j, convert.index_of(j, device="cpu")

    regs = [build(r, c) for r, c in ((base, CAP_BASE), (ci, CAP), (cd, CAP),
                                     (ui, CAP), (ud, CAP))]
    if case == "n_is_cap":
        assert all(int(t.n) == t.capacity for _j, t in regs)
    return regs, CAP


@jax.jit
def j_base_bits(base, udel):
    """The JAX store's probe: udel's rows in base, int32."""
    lt, le = jcsr.index_ranks(base, jcsr._qcols_of(udel), udel.val)
    return (le > lt).astype(np.int32)


def _ids():
    return [f"{lay}-{case}" for lay in LAYOUTS for case in CASES]


PARAMS = [(lay, case) for lay in LAYOUTS for case in CASES]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


@pytest.mark.parametrize("layout,case", PARAMS, ids=_ids())
def test_in_ba_form_matches_jax_kernel(layout, case):
    regs, cap = fold_case(layout, case)
    (jb, tb), (jci, tci), (jcd, tcd), (jui, tui), (jud, tud) = regs
    j_in_ba = j_base_bits(jb, jud)
    in_ba = base_bits(tb, tud)
    same(in_ba, j_in_ba)
    got = commit_fold(tci, tcd, tui, tud, in_ba, cins_cap=cap, cdel_cap=cap)
    kern = jfold.commit_fold(jci, jcd, jui, jud, j_in_ba, cins_cap=cap,
                             cdel_cap=cap, interpret=True)
    for g, k in zip(got, kern):
        same_index(g, k)


@pytest.mark.parametrize("layout,case", PARAMS, ids=_ids())
def test_base_form_matches_jax_chain_and_in_ba_form(layout, case):
    regs, cap = fold_case(layout, case)
    (jb, tb), (jci, tci), (jcd, tcd), (jui, tui), (jud, tud) = regs
    got = commit_fold(tci, tcd, tui, tud, base=tb, cins_cap=cap,
                      cdel_cap=cap)
    chain = jdelta._commit_fold_safe(jb, jci, jcd, jui, jud, cins_cap=cap,
                                     cdel_cap=cap, sharded=False,
                                     use_kernel=False)
    other = commit_fold(tci, tcd, tui, tud, base_bits(tb, tud),
                        cins_cap=cap, cdel_cap=cap)
    n_oci = int(got[0].n)
    if case in ("n_is_cap", "overflow"):
        assert n_oci > CAP
    if case == "out_exactly_full":
        assert n_oci == CAP
    if case == "udel_not_in_base":
        assert int(tud.n) > 0 and int(base_bits(tb, tud).sum()) == 0
    for g, c, o in zip(got, chain, other):
        same_index(g, c)
        for a, b in ((g.key, o.key), (g.val, o.val), (g.n, o.n)):
            assert torch.equal(a, b)
        assert (g.lo is None) == (o.lo is None)
        assert g.lo is None or torch.equal(g.lo, o.lo)


@pytest.mark.parametrize("given", ["both", "neither"])
def test_exactly_one_of_in_ba_and_base(given):
    regs, cap = fold_case("i32", "mixed")
    _b, tb = regs[0]
    tci, tcd, tui, tud = (t for _j, t in regs[1:])
    in_ba = base_bits(tb, tud) if given == "both" else None
    base = tb if given == "both" else None
    with pytest.raises(ValueError, match="exactly one"):
        commit_fold(tci, tcd, tui, tud, in_ba, base=base, cins_cap=cap,
                    cdel_cap=cap)
