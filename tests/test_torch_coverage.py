"""Kernel coverage of the port (``RegionStore.kernel_coverage``,
``GraphSession.kernel_coverage``, ``launch.kernel_coverage``) on the CPU:
the JAX package's relations and keys, pure introspection (the store's
snapshot leaf for leaf the same before and after), and the gate's record
with zero warm compiles.  The launch counts are the card's: the plain
versions launch nothing, so they are 0 here."""
import json

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = {"composite", "key_dtype", "fold_pallas_calls", "fused_fold",
        "probe_pallas_calls"}


def _session(pkg, **kw):
    """The coverage gate's two-session pipeline, small: triangle feeder, the
    streamed ``tri`` relation, a standing 4-clique-tri."""
    edges = pkg.uniform_graph(64, 192, seed=7)
    sess = pkg.GraphSession(edges, local=True, batch=1024,
                            out_capacity=1 << 14, update_batch=64, **kw)
    tri0, _ = sess.register("triangle").enumerate()
    sess.add_relation("tri", tri0)
    sess.register("4-clique-tri")
    return sess


class _Pkg:
    def __init__(self, api, synthetic):
        self.GraphSession = api.GraphSession
        self.uniform_graph = synthetic.uniform_graph


@pytest.fixture(scope="module")
def port_session():
    from repro_torch import api
    from repro_torch.data import synthetic
    return _session(_Pkg(api, synthetic), device="cpu")


def test_kernel_coverage_has_the_jax_relations_and_keys(port_session,
                                                        monkeypatch):
    import jax
    import jax.extend.core as jcore
    from repro import api
    from repro.data import synthetic
    # the JAX package's jaxpr walk names jax.core.ClosedJaxpr/Jaxpr, which
    # jax 0.9 moved to jax.extend.core (ROADMAP Queue 3)
    monkeypatch.setattr(jax.core, "ClosedJaxpr", jcore.ClosedJaxpr,
                        raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", jcore.Jaxpr, raising=False)
    want = _session(_Pkg(api, synthetic)).kernel_coverage()
    got = port_session.kernel_coverage()
    assert set(got) == set(want) == {"edge", "tri"}
    for rel in want:
        assert set(got[rel]) == set(want[rel]) == KEYS
        assert got[rel]["composite"] == want[rel]["composite"]
        assert got[rel]["key_dtype"] == want[rel]["key_dtype"]
    assert got["tri"]["composite"] and not got["edge"]["composite"]
    # the plain versions launch nothing
    assert all(c["fold_pallas_calls"] == c["probe_pallas_calls"] == 0
               and not c["fused_fold"] for c in got.values())


def test_kernel_coverage_is_pure_introspection(port_session):
    store = port_session.store
    leaves0, meta0 = port_session.snapshot()
    marks0 = dict(store.ratchet.marks())
    stats0 = (store.stats.commit_calls, store.stats.epochs)
    for ub in (64, 1000):
        store.kernel_coverage(ub)
    leaves1, meta1 = port_session.snapshot()
    assert meta1 == meta0
    assert len(leaves1) == len(leaves0)
    for a, b in zip(leaves0, leaves1):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert store.ratchet.marks() == marks0
    assert (store.stats.commit_calls, store.stats.epochs) == stats0


def test_kernel_coverage_cli(capsys):
    from repro_torch.launch import kernel_coverage
    rc = kernel_coverage.main(["--scale", "6", "--epochs", "3",
                               "--warmup", "1", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"], rec["failures"]
    # the JAX package's record keys
    assert {"gate", "prewarm_compiles", "warm_compiles", "epoch_compiles",
            "coverage", "composite_relations", "ok", "failures"} <= set(rec)
    assert rec["warm_compiles"] == 0
    assert rec["composite_relations"] == ["tri"]
    assert rec["launch_gate"] == "not held on the host"
    assert {c["fold_pallas_calls"] for c in rec["coverage"].values()} == {0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kernel_coverage.main(["--scale", "4"])
