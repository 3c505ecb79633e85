"""Logical-axis sharding rules: model dimensions are named once
(``models.transformer.logical_axes``: "embed", "vocab", "expert", ...)
and a :class:`ShardingRules` table maps each name to physical mesh axes
("pod", "data", "model"), the JAX package's MaxText-style indirection.

The port keeps the table and its shape-aware mapping as plain data: a
mesh is a mapping of axis name to size and a spec is a tuple, one entry
a dimension (``None``, an axis name, or a tuple of names where the rule
declares a tuple).  Where the JAX package's ``logical_sharding``,
``shard_params`` and ``sharding_tree`` build ``NamedSharding`` objects
for XLA, :func:`shard_shape` and :func:`shard_tree` give what a
``NamedSharding`` leaves on each device, its shard shape: the dry run
(``launch.dryrun``) sums their bytes.  A spec XLA would refuse (an axis
named twice, or one that does not divide its dimension) raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

# default logical->physical table for the production meshes
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": ("pod", "data"),  # DP over pods x data axis
    "batch_dp3": ("pod", "data", "model"),  # ZeRO-3 cells: DP everywhere
    "seq": None,  # sequence kept unsharded by default (SP selectively)
    "seq_shard": "model",  # sequence parallelism for long-context cells
    "embed": "data",  # FSDP: weight embed-dim over the DP axis
    "mlp": "model",  # TP: hidden of MLPs
    "heads": "model",  # TP: attention heads
    "kv_heads": "model",
    "vocab": "model",  # TP: embedding/unembedding
    "expert": "model",  # EP: MoE experts
    "nodes": ("pod", "data"),  # GNN: node partition
    "edges": ("pod", "data"),  # GNN: edge partition
    "feat": None,
    "table_rows": "model",  # recsys: embedding tables row-sharded
    "candidates": ("pod", "data"),  # retrieval scoring partition
    "workers": ("pod", "data", "model"),  # WCOJ: every chip is a worker
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Tuple[Tuple[str, Optional[object]], ...]

    @classmethod
    def default(cls, **overrides) -> "ShardingRules":
        t = dict(DEFAULT_RULES)
        t.update(overrides)
        return cls(tuple(sorted(t.items(), key=lambda kv: kv[0])))

    def physical(self, logical: Tuple[Optional[str], ...],
                 mesh: Mapping[str, int],
                 shape: Optional[Tuple[int, ...]] = None) -> tuple:
        """Logical -> physical spec over ``mesh`` (axis name -> size).  An
        axis serves one dimension at most; with ``shape``, an axis that
        does not divide its dimension (with the axes kept before it) is
        dropped, and the next dimension mapped to it may take it (8
        experts cannot shard over a 16-way axis; mixtral's mlp dim then
        gets it)."""
        sizes = dict(mesh)
        axes = []
        used = set()
        t = dict(self.table)
        for i, name in enumerate(logical):
            if name is None:
                axes.append(None)
                continue
            phys = t.get(name)
            cands = (phys if isinstance(phys, tuple)
                     else ((phys,) if phys else ()))
            kept, prod = [], 1
            for p in cands:
                if p not in sizes or p in used:
                    continue
                if shape is not None and shape[i] % (prod * sizes[p]) != 0:
                    continue
                kept.append(p)
                used.add(p)
                prod *= sizes[p]
            if not kept:
                axes.append(None)
            elif isinstance(phys, tuple):
                axes.append(tuple(kept))  # keep the declared tuple form
            else:
                axes.append(kept[0])
        return tuple(axes)


def shard_shape(shape: Tuple[int, ...], spec: tuple,
                mesh: Mapping[str, int]) -> Tuple[int, ...]:
    """Each device's shard of a ``shape`` array laid out by the physical
    ``spec`` (one entry per leading dimension, the rest unsharded) over
    ``mesh``.  Raises ``ValueError`` for an axis the mesh lacks, an axis
    named twice, or axes whose sizes do not divide their dimension."""
    shape = tuple(int(d) for d in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out, seen = list(shape), set()
    for i, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = 1
        for a in names:
            if a not in mesh:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{dict(mesh)}")
            if a in seen:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            seen.add(a)
            n *= int(mesh[a])
        if shape[i] % n:
            raise ValueError(f"spec {spec}: axes {names} of {n} devices do "
                             f"not divide dimension {i} of {shape}")
        out[i] = shape[i] // n
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def dotted_axes(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict of logical axes by dotted name (a module's
    ``named_parameters`` names)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(dotted_axes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def shard_tree(logical_axes, template, mesh: Mapping[str, int],
               rules: Optional[ShardingRules] = None
               ) -> List[Tuple[str, Any, Tuple[int, ...]]]:
    """(path, leaf, shard shape) for every leaf of ``template``: tensors,
    and ints (a 0-d int32, as the JAX programs carry them).  The template
    is a tree of modules (their parameters by dotted name), dataclasses,
    dicts, tuples and lists; ``logical_axes`` mirrors it, a module's axes
    a nested dict of its parameters' names.  An axes tuple where the
    template has a subtree applies to each of its leaves (a JAX tree
    prefix).  Each leaf's spec is ``rules.physical(axes, mesh, shape)``."""
    rules = rules or ShardingRules.default()
    out: List[Tuple[str, Any, Tuple[int, ...]]] = []

    def leaf(path, ax, x):
        shape = () if isinstance(x, int) else tuple(x.shape)
        out.append((path, x, shard_shape(
            shape, rules.physical(ax, mesh, shape), mesh)))

    def walk(path, ax, x):
        if x is None:
            return
        if isinstance(x, (int, torch.Tensor)):
            if not _is_axes(ax):
                raise ValueError(f"{path}: logical axes {ax!r} for a leaf")
            leaf(path, ax, x)
            return
        if isinstance(x, torch.nn.Module):
            named = dotted_axes(ax) if isinstance(ax, dict) else None
            for k, p in x.named_parameters():
                walk(f"{path}.{k}", ax if named is None else named[k], p)
            return
        if dataclasses.is_dataclass(x):
            items = [(f.name, getattr(x, f.name))
                     for f in dataclasses.fields(x)]
            sub = [ax] * len(items) if _is_axes(ax) else \
                [getattr(ax, k) for k, _ in items]
        elif isinstance(x, dict):
            items = list(x.items())
            sub = [ax] * len(items) if _is_axes(ax) else \
                [ax[k] for k, _ in items]
        elif isinstance(x, (tuple, list)):
            items = list(enumerate(x))
            sub = [ax] * len(items) if _is_axes(ax) else list(ax)
            if len(sub) != len(items):
                raise ValueError(f"{path}: {len(sub)} axes for "
                                 f"{len(items)} entries")
        else:
            raise TypeError(f"{path}: no shard layout for {type(x)}")
        for (k, v), a in zip(items, sub):
            walk(f"{path}.{k}" if path else str(k), a, v)

    walk("", logical_axes, template)
    return out
