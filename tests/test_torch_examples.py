"""The examples' PyTorch twins (``examples/torch_*.py``) end to end on the
CPU at their smallest sizes: each ``main`` runs with ``device="cpu"`` and
prints its "✓" checks (against the serial Generic Join oracle, the
edge-only twin plan, or the plain GNN)."""
import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

CASES = {
    "torch_quickstart": dict(scale=7, edge_factor=6),
    "torch_incremental_motifs": dict(scale=8, edge_factor=6, batches=2,
                                     batch_size=64),
    "torch_multi_relation": dict(scale=7, edge_factor=6, epochs=2,
                                 batch_size=64),
    "torch_train_gnn_with_motifs": dict(scale=10, steps=60),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_runs_on_the_cpu(name, capsys):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu", **CASES[name])
    out = capsys.readouterr().out
    assert "✓" in out, out
