"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's cells, on the CPU, without a 512-device compile: the JAX side
goes through its abstract functions (``build(None)``'s ShapeDtypeStructs,
``ShardingRules.physical`` over an ``AbstractMesh``).

- Registry parity: every JAX arch and cell, with its kind, skip reason
  and probe settings.
- Argument and donated bytes of one cell of each kind per family, on
  both production meshes, equal to the JAX cell's sharded bytes exactly.
- Meta against real: the FLOP count and the peak of allocated bytes of a
  smoke-width step on ``meta`` equal the same step's on CPU tensors, and
  extrapolation from depths (1, 2) to 4 equals the direct count at 4.
- The kernel wrappers' meta branch: the plain version's shapes and
  dtypes, the stated operation counts, no launch; the CPU path unchanged.
- The CLI: an ok record, a skipped one with the JAX text, an error with
  exit code 1.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.distributed import sharding as JS
from repro_torch import kernels
from repro_torch.configs import base as TB
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import lm_archs as TA
from repro_torch.configs import lm_family as LF
from repro_torch.configs import registry as TR
from repro_torch.distributed import sharding as TS
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.segment_ops import ops as sops
from repro_torch.kernels.segment_ops.ref import segment_sum_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TT

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# one cell of each kind per family (MoE and dense train cells apart)
CELLS = [("mixtral-8x7b", "train_4k"), ("gemma2-2b", "train_4k"),
         ("yi-34b", "prefill_32k"), ("llama4-scout-17b-a16e", "decode_32k"),
         ("gemma2-2b", "long_500k"), ("graphcast", "ogb_products"),
         ("egnn", "molecule"), ("two-tower-retrieval", "train_batch"),
         ("two-tower-retrieval", "serve_p99"),
         ("two-tower-retrieval", "retrieval_cand"),
         ("wcoj-subgraph", "triangle_static"),
         ("wcoj-subgraph", "diamond_delta_1m")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_parity():
    assert list_archs() == jlist_archs()
    for arch in jlist_archs():
        jspec, tspec = jget_arch(arch), get_arch(arch)
        assert tspec.family == jspec.family, arch
        assert list(tspec.cells) == list(jspec.cells), arch
        for name, jc in jspec.cells.items():
            tc = tspec.cells[name]
            assert (tc.shape_name, tc.kind, tc.skip_reason,
                    tc.probe is None, tc.probe_depths, tc.full_depth,
                    tc.probe_scale) == \
                (jc.shape_name, jc.kind, jc.skip_reason, jc.probe is None,
                 jc.probe_depths, jc.full_depth, jc.probe_scale), \
                (arch, name)


def _is_ax(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _jax_bytes(arch, shape, multi):
    """(argument bytes, donated bytes) of one device's shards of the JAX
    cell: each leaf's ``ShardingRules.physical`` spec over an
    AbstractMesh, or, for the wcoj cells (``shard_map`` over every
    axis), the leading dimension split over every device."""
    sizes, names = MESHES[multi]
    jmesh = AbstractMesh(sizes, names)
    dims = dict(zip(names, sizes))
    cell = jget_arch(arch).cells[shape]
    _, args, axes, donate = cell.build(jmesh if arch == "wcoj-subgraph"
                                       else None)
    rules = JS.ShardingRules.default()

    def nbytes(leaf, spec):
        shp = list(leaf.shape)
        for i, e in enumerate(spec):
            ax = () if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e))
            n = int(np.prod([dims[a] for a in ax]))
            assert shp[i] % n == 0
            shp[i] //= n
        return int(np.prod(shp)) * leaf.dtype.itemsize

    per = []
    for i, a in enumerate(args):
        if axes is None:
            per.append(sum(nbytes(l, (names,)) for l in jax.tree.leaves(a)))
        else:
            per.append(sum(jax.tree.leaves(jax.tree.map(
                lambda ax, l: nbytes(l, rules.physical(ax, jmesh,
                                                       l.shape)),
                axes[i], a, is_leaf=_is_ax))))
    return sum(per), sum(per[i] for i in donate)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_jax(arch, shape, multi):
    mesh = make_production_mesh(multi)
    _, args, axes, donate = get_arch(arch).cells[shape].build(mesh)
    got = dryrun.argument_bytes(args, axes, donate, mesh)
    assert got == _jax_bytes(arch, shape, multi)


def test_shard_shape_refuses_what_xla_would():
    mesh = make_production_mesh(True)
    assert TS.shard_shape((256, 4096), (("data", "model"), None), mesh) == \
        (1, 4096)
    assert TS.shard_shape((4, 512, 8), (None, "model"), mesh) == (4, 32, 8)
    for shape, spec in [((256, 64), ("data", "data")),
                        ((256, 64), (("data", "model"), "model")),
                        ((24, 64), ("data", None)),
                        ((256,), ("data", None)),
                        ((256, 64), ("rows", None))]:
        with pytest.raises(ValueError):
            TS.shard_shape(shape, spec, mesh)


def _smoke(cfg, depth):
    return dataclasses.replace(cfg, num_layers=depth)


SMOKE_SHAPES = {"train": dict(batch=4, seq=64, microbatches=2),
                "prefill": dict(batch=2, seq=48),
                "decode": dict(batch=2, seq=40)}


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["MIXTRAL_8X7B", "GEMMA2_2B"])
def test_meta_counts_equal_the_cpu_run(arch, kind, monkeypatch):
    """The same step on ``meta`` and on CPU tensors.  Training reaches no
    kernel: equal FLOPs and equal peaks of allocated bytes.  Serving
    attends through ``mha``: the CPU run's plain version multiplies every
    (query, key) pair, 4 Dh B Hq Sq Sk FLOPs a call, where the meta run
    adds the kernel's count of live pairs instead; the rest is equal."""
    calls = []

    def recorded(q, k, v, causal=True, window=0, softcap=0.0, q_offset=0):
        calls.append((tuple(q.shape), k.shape[1], causal, window,
                      q_offset))
        return fops.mha(q, k, v, causal, window, softcap, q_offset)
    monkeypatch.setattr(TT, "mha", recorded)
    cfg = getattr(TA, arch).smoke_config
    make = LF.CELL_OF[kind]
    meta = dryrun.count(*make(cfg, SMOKE_SHAPES[kind])[:2])
    n = len(calls)
    cpu = dryrun.count(*make(cfg, SMOKE_SHAPES[kind], device="cpu")[:2])
    assert calls[:n] == calls[n:]
    assert cpu["kernel_ops"] == {"flash_attention": 0, "segment_sum": 0}
    plain = sum(4 * s[3] * s[0] * s[2] * s[1] * sk
                for s, sk, *_ in calls[n:])
    assert cpu["torch_flops"] - meta["torch_flops"] == plain
    assert meta["kernel_ops"]["flash_attention"] == sum(
        fops.kernel_ops(*c) for c in calls[:n])
    assert (kind == "train") == (n == 0)
    if kind == "train":
        assert meta["flops"] == cpu["flops"] > 0
        assert meta["temp_bytes"] == cpu["temp_bytes"] > 0


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
def test_probe_extrapolation_equals_the_direct_count(kind):
    cfg = TA.YI_34B.smoke_config
    make = LF.CELL_OF[kind]
    shape = SMOKE_SHAPES[kind]
    cell = TB.Cell("probe", kind,
                   lambda mesh: make(_smoke(cfg, 4), shape), None,
                   lambda mesh, d: make(_smoke(cfg, d), shape), (1, 2), 4)
    mesh = make_production_mesh(False)
    ex = dryrun.cell_counts(cell, mesh, no_probe=False)
    direct = dryrun.cell_counts(cell, mesh, no_probe=True)
    assert ex["flops"] == direct["flops"]
    assert ex["kernel_ops"] == direct["kernel_ops"]
    assert ex["probe"]["depths"] == [1, 2]


def _live_pairs(sq, sk, causal, window, q_offset):
    q = q_offset + np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= k <= q
    if window:
        m &= k > q - window
    return int(m.sum())


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, Hkv, Dh, Sk, causal, window, q_offset, dtype)
    (2, 40, 4, 2, 32, 40, True, 0, 0, torch.bfloat16),
    (1, 33, 8, 8, 64, 33, True, 8, 0, torch.float32),
    (2, 1, 4, 2, 32, 50, True, 16, 45, torch.bfloat16),
    (1, 12, 4, 1, 16, 20, False, 0, 0, torch.float32)])
def test_mha_meta_branch(case):
    B, Sq, Hq, Hkv, Dh, Sk, causal, window, off, dt = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, Sq, Hq, Dh), generator=g).to(dt)
    k = torch.randn((B, Sk, Hkv, Dh), generator=g).to(dt)
    v = torch.randn((B, Sk, Hkv, Dh), generator=g).to(dt)
    kernels.reset_meta_ops()
    kernels.reset_launches()
    want = mha_ref(q, k, v, causal=causal, window=window, q_offset=off)
    got = fops.mha(q, k, v, causal, window, 0.0, off)
    assert torch.equal(got, want)  # the CPU path: the plain version
    assert kernels.META_OPS["flash_attention"] == 0
    m = fops.mha(q.to("meta"), k.to("meta"), v.to("meta"), causal, window,
                 0.0, off)
    assert m.is_meta and m.shape == want.shape and m.dtype == want.dtype
    ops = 4 * Dh * B * Hq * _live_pairs(Sq, Sk, causal, window, off)
    assert fops.kernel_ops(tuple(q.shape), Sk, causal, window, off) == ops
    assert kernels.META_OPS["flash_attention"] == ops
    assert not any(kernels.launches().values())
    h = fops.flash_attention(q[0].transpose(0, 1).to("meta"),
                             k[0].transpose(0, 1).to("meta").repeat(
                                 Hq // Hkv, 1, 1)[:Hq],
                             v[0].transpose(0, 1).to("meta").repeat(
                                 Hq // Hkv, 1, 1)[:Hq],
                             causal=causal, window=window, q_offset=off)
    assert h.is_meta and h.shape == (Hq, Sq, Dh) and h.dtype == dt


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("E,D,NS,dt", [(1000, 7, 40, torch.float32),
                                       (70, 16, 9, torch.float16),
                                       (0, 3, 5, torch.float32),
                                       (33, 4, 3, torch.bfloat16)])
def test_segment_sum_meta_branch(E, D, NS, dt, sorted_ids):
    rng = np.random.default_rng(E + D)
    ids = rng.integers(0, NS + 1, E)  # NS: dropped
    if sorted_ids:
        ids = np.sort(ids)
    data = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32)
                            ).to(dt)
    seg = torch.from_numpy(ids.astype(np.int32))
    kernels.reset_meta_ops()
    kernels.reset_launches()
    got = sops.segment_sum(data, seg, NS, is_sorted=sorted_ids)
    assert torch.equal(got, segment_sum_ref(data, seg, NS))
    assert kernels.META_OPS["segment_sum"] == 0
    m = sops.segment_sum(data.to("meta"), seg.to("meta"), NS,
                         is_sorted=sorted_ids)
    assert m.is_meta and m.shape == got.shape and m.dtype == got.dtype
    assert kernels.META_OPS["segment_sum"] == sops.kernel_ops(E, D) == E * D
    assert not any(kernels.launches().values())
    live = dryrun.LiveBytes()
    mdata, mseg = data.to("meta"), seg.to("meta")
    with live:
        sops.segment_sum(mdata, mseg, NS, is_sorted=True)
    cast = E * D * 4 if dt == torch.bfloat16 else 0
    assert live.peak == cast + 4 * sops.scratch_words(E, D) + NS * D * 4


def _records(path):
    return [json.loads(l) for l in path.read_text().splitlines()]


def test_cli_ok_record(tmp_path):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    (rec,) = _records(out)
    assert (rec["status"], rec["chips"], rec["mesh"], rec["kind"]) == \
        ("ok", 256, "16x16", "decode")
    pd = rec["per_device"]
    assert pd["alias_bytes"] < pd["argument_bytes"] and pd["temp_bytes"] > 0
    assert rec["flops_basis"] == "counted"
    assert rec["kernel_ops_per_device"]["flash_attention"] > 0
    assert rec["roofline"]["collective_s"] is None
    assert rec["probe"]["depths"] == [2, 4]


@pytest.mark.parametrize("multi", [False, True])
def test_wcoj_cells_report_a_collective_time(multi):
    """The wcoj cells' ``collective_s``: the bytes a device sends in one
    step (the exchange count's model at the cell's shapes) over NVLink
    within a node and NDR between nodes, a term of ``bound_s``."""
    from repro_torch.configs import wcoj
    from repro_torch.launch import mesh as M
    for shape in wcoj.SHAPES:
        rec = dryrun.run_cell("wcoj-subgraph", shape, multi, verbose=False)
        roof = rec["roofline"]
        chips = rec["chips"]
        sent = wcoj.step_exchange_bytes(shape, chips)
        assert roof["collective_bytes_per_device"] == sent > 0
        peers = chips - 1
        assert roof["collective_s"] == max(
            sent * 7 / peers / M.NVLINK_BYTES_PER_S,
            sent * (peers - 7) / peers / M.NDR_BYTES_PER_S) > 0
        assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
        assert roof["dominant"] in ("compute", "memory", "collective")


def test_cli_skipped_record(tmp_path):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    recs = _records(out)
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    want = jget_arch("yi-34b").cells["long_500k"].skip_reason
    assert all(r["status"] == "skipped" and r["skip_reason"] == want
               for r in recs)


def test_cli_error_record(tmp_path, monkeypatch):
    """A cell whose step reads a value on the host (which a meta tensor
    does not hold) comes out as an error, and the run exits 1."""
    def build(mesh):
        x = torch.empty((64, 64), device="meta")
        return (lambda a: int(a.sum())), (x,), ((None, None),), ()
    spec = TB.ArchSpec("broken", "lm", "a cell that raises", None, None,
                       {"bad": TB.Cell("bad", "prefill", build)}, None,
                       lambda shape: 1.0)
    monkeypatch.setattr(TR, "_all", lambda: {"broken": spec})
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "broken", "--out", str(out)]) == 1
    recs = _records(out)
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"] == "error" and "meta" in r["error"]
               for r in recs)
