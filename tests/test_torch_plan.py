"""Query metadata, plans and the pattern DSL of the port equal the JAX
package's field by field."""
import dataclasses

import pytest

from repro.api import dsl as jdsl
from repro.core import plan as jplan
from repro.core import query as jquery
from repro_torch.api import dsl as tdsl
from repro_torch.core import plan as tplan
from repro_torch.core import query as tquery


def plain(x):
    """A framework-neutral view of a (nested) dataclass value."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    return x


NAMES = list(jquery.QUERY_REGISTRY)


@pytest.mark.parametrize("name", NAMES)
def test_registry_queries_and_plans_match(name):
    jq, tq = jquery.query_by_name(name), tquery.query_by_name(name)
    assert plain(jq) == plain(tq)
    jp, tp = jplan.make_plan(jq), tplan.make_plan(tq)
    assert plain(jp) == plain(tp)
    assert jp.index_ids() == tp.index_ids()
    assert jp.seed_width == tp.seed_width
    assert jquery.fractional_edge_cover(jq) == \
        tquery.fractional_edge_cover(tq)


@pytest.mark.parametrize("name", NAMES)
def test_delta_plans_match(name):
    jq, tq = jquery.query_by_name(name), tquery.query_by_name(name)
    jdq, tdq = jquery.delta_queries(jq), tquery.delta_queries(tq)
    assert len(jdq) == len(tdq)
    for a, b in zip(jdq, tdq):
        assert a.versions == b.versions
        ja, tb = jplan.make_delta_plan(a), tplan.make_delta_plan(b)
        assert plain(ja) == plain(tb)
        assert ja.index_ids() == tb.index_ids()
        assert (ja.seed_cols, ja.seed_width) == (tb.seed_cols, tb.seed_width)


@pytest.mark.parametrize("name", NAMES)
def test_dsl_round_trip_matches(name):
    jq, tq = jquery.query_by_name(name), tquery.query_by_name(name)
    assert jdsl.pattern_of(jq) == tdsl.pattern_of(tq)
    assert plain(jdsl.parse_pattern(jdsl.pattern_of(jq))) == \
        plain(tdsl.parse_pattern(tdsl.pattern_of(tq)))


@pytest.mark.parametrize("name", ["triangle", "4-clique", "5-clique",
                                  "house"])
def test_symmetric_plans_match(name):
    jq = jquery.query_by_name(name, symmetric=True)
    tq = tquery.query_by_name(name, symmetric=True)
    assert plain(jplan.make_plan(jq)) == plain(tplan.make_plan(tq))
