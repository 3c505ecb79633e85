"""Static BiGJoin of the port (plain versions on the CPU) against the JAX
package's ``run_bigjoin`` on the same graph and plan: count, collected
tuples in order, weights, proposals, intersections and steps, exactly."""
import numpy as np
import pytest

from repro.core import bigjoin as jbj
from repro.core import plan as jplan
from repro.core import query as jquery
from repro.data.synthetic import uniform_graph
from repro_torch.core import bigjoin as tbj
from repro_torch.core import plan as tplan
from repro_torch.core import query as tquery
from repro_torch.core.generic_join import generic_join


RECIPROCAL = "recip(a, b, c) := e(a, b), e(b, a), e(a, c), e(c, b), a < c"


def _queries(name):
    """(JAX query, port query): registry names, ``sym:`` for the
    symmetry-breaking variant (level filters), or the DSL pattern with a
    reciprocal edge (a seed filter through the membership wrapper)."""
    if name == "recip":
        from repro.api.dsl import parse_pattern as jparse
        from repro_torch.api.dsl import parse_pattern as tparse
        return jparse(RECIPROCAL), tparse(RECIPROCAL)
    sym = name.startswith("sym:")
    name = name[4:] if sym else name
    return (jquery.query_by_name(name, symmetric=sym),
            tquery.query_by_name(name, symmetric=sym))


@pytest.mark.parametrize("name", ["triangle", "4-clique", "diamond",
                                  "5-clique", "house", "sym:triangle",
                                  "recip"])
def test_run_bigjoin_matches_jax(name):
    edges = uniform_graph(48, 420, seed=5)
    rel = {"edge": edges}
    jq, tq = _queries(name)
    jp = jplan.make_plan(jq)
    tp = tplan.make_plan(tq)
    # a small B' forces rem-ext resumption across many steps
    jcfg = jbj.BigJoinConfig(batch=64, seed_chunk=128, out_capacity=1 << 14,
                             use_kernel=False)
    tcfg = tbj.BigJoinConfig(batch=64, seed_chunk=128, out_capacity=1 << 14)
    seed = jbj.seed_tuples_for(jp, rel)
    np.testing.assert_array_equal(seed, tbj.seed_tuples_for(tp, rel))
    want = jbj.run_bigjoin(jp, jbj.build_indices(jp, rel), seed, cfg=jcfg)
    got = tbj.run_bigjoin(tp, tbj.build_indices(tp, rel, device="cpu"),
                          seed, cfg=tcfg)
    assert got.count == want.count
    assert (got.proposals, got.intersections, got.steps) == \
        (want.proposals, want.intersections, want.steps)
    assert got.tuples.dtype == want.tuples.dtype
    np.testing.assert_array_equal(got.tuples, want.tuples)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.count == generic_join(tq, rel)[1]


def test_count_mode_and_overflow():
    from repro_torch.errors import CapacityOverflow, OVF_OUT
    edges = uniform_graph(40, 300, seed=2)
    rel = {"edge": edges}
    tp = tplan.make_plan(tquery.query_by_name("triangle"))
    idx = tbj.build_indices(tp, rel, device="cpu")
    seed = tbj.seed_tuples_for(tp, rel)
    full = tbj.run_bigjoin(tp, idx, seed, cfg=tbj.BigJoinConfig(
        batch=64, seed_chunk=128, out_capacity=1 << 12))
    cnt = tbj.run_bigjoin(tp, idx, seed, cfg=tbj.BigJoinConfig(
        batch=64, seed_chunk=128, mode="count"))
    assert cnt.count == full.count > 8 and cnt.tuples is None
    with pytest.raises(CapacityOverflow) as exc:
        tbj.run_bigjoin(tp, idx, seed, cfg=tbj.BigJoinConfig(
            batch=64, seed_chunk=128, out_capacity=8))
    assert exc.value.mask & OVF_OUT
