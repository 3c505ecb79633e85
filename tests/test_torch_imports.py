"""The port stands alone: ``repro_torch``, the example twins
(``examples/torch_*.py``) and ``chip_smoke.py`` import neither ``jax`` nor
the JAX package ``repro``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .replace(".__init__", "")
    for p in PKG.rglob("*.py"))
TWINS = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "examples").glob("torch_*.py"))

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_every_module_imports_without_jax_or_repro():
    assert len(TWINS) == 5, TWINS
    assert {"repro_torch.serve.pool", "repro_torch.serve.wal",
            "repro_torch.serve._serve_check", "repro_torch.launch.serve",
            "repro_torch.launch.run_query",
            "repro_torch.core.compilestats",
            "repro_torch.core.distributed", "repro_torch.core.balance",
            "repro_torch.core._dist_check", "repro_torch.launch.mesh",
            "repro_torch.core._delta_dist_check",
            "repro_torch.core._nary_dist_check",
            "repro_torch.launch.kernel_coverage",
            "repro_torch.models.recsys",
            "repro_torch.configs.recsys_family",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.dryrun",
            "repro_torch.configs.wcoj"} <= set(MODULES)
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util as u\n"
        f"for p in {TWINS!r}:\n"
        "    s = u.spec_from_file_location(p.split('/')[-1][:-3], p)\n"
        "    s.loader.exec_module(u.module_from_spec(s))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path", [p.relative_to(ROOT).as_posix() for p in sorted(PKG.rglob("*.py"))]
    + TWINS + ["chip_smoke.py"])
def test_source_has_no_jax_or_repro_import(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(src), path


def test_cuda_sources_are_complete():
    """Every kernel library the build names has its source, and the
    package lists the kernels of the slices ported so far with their
    launch variants."""
    from repro_torch.kernels import KERNELS, VARIANTS, VARIANTS_OF
    from repro_torch.kernels._build import CSRC, SOURCES
    for name in SOURCES:
        assert (CSRC / f"{name}.cu").exists()
    assert KERNELS == ("signed_member", "member", "fused_extend",
                       "rank_lt_le", "commit_fold", "segment_sum",
                       "flash_attention")
    assert VARIANTS_OF["segment_sum"] == ("segment_sum",)
    assert VARIANTS_OF["flash_attention"] == ("flash_attention",)
    assert VARIANTS_OF["member"] == ("member", "member_lex")
    assert VARIANTS_OF["commit_fold"] == ("commit_fold", "commit_fold_lex",
                                          "commit_fold_w",
                                          "commit_fold_lex_w")
    assert len(VARIANTS) == 14
