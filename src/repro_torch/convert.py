"""Carry state across packages: host arrays (``key``, ``val``, ``n`` as
numpy, e.g. ``np.asarray`` of another package's index fields) become the
port's :class:`IndexData` / :class:`VersionedIndex`, a GNN parameter
tree of host arrays the port's ``GNN`` (:func:`gnn_params`), a
transformer's the port's ``Transformer`` (:func:`transformer_params`) and
a two-tower model's the port's (:func:`recsys_params`), on the device the
caller names (``device`` is required: a conversion never picks one).

Duck-typed: anything with ``key``/``val``/``n`` attributes (and an optional
composite ``lo`` word) converts, so the parity tests can feed both packages
identical regions without this module importing either framework's other
package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import IndexData
from repro_torch.core.dataflow_index import VersionedIndex


def to_index(key, val, n, lo=None, *, device) -> IndexData:
    """One region from host arrays: key [cap] int32|int64, val [cap]
    int32, n scalar live count, lo [cap] int64 (composite keys) or None."""
    key = np.ascontiguousarray(np.asarray(key))
    if key.dtype not in (np.int32, np.int64):
        raise TypeError(f"unsupported key dtype {key.dtype}")
    val = np.ascontiguousarray(np.asarray(val, np.int32))
    n = int(np.asarray(n))
    if lo is not None:
        lo = np.asarray(lo)
        if lo.dtype != np.int64 or lo.shape != key.shape:
            raise TypeError("a composite lo word is int64 shaped like key")
        lo = torch.from_numpy(lo.copy()).to(device)
    return IndexData(torch.from_numpy(key.copy()).to(device),
                     torch.from_numpy(val.copy()).to(device),
                     torch.tensor(n, dtype=torch.int32, device=device), lo)


def index_of(region, *, device) -> IndexData:
    """A region object with ``key``/``val``/``n`` and optionally ``lo``."""
    return to_index(np.asarray(region.key), np.asarray(region.val),
                    np.asarray(region.n),
                    None if getattr(region, "lo", None) is None
                    else np.asarray(region.lo), device=device)


def versioned_of(vi, *, device) -> VersionedIndex:
    """A versioned index object with ``pos``/``neg`` region sequences."""
    return VersionedIndex(tuple(index_of(r, device=device) for r in vi.pos),
                          tuple(index_of(r, device=device) for r in vi.neg))


def to_numpy(idx: IndexData):
    """(key, val, n) of a port region as host arrays (a composite region's
    lo word is ``idx.lo``)."""
    return (idx.key.cpu().numpy(), idx.val.cpu().numpy(),
            np.int32(int(idx.n)))


def _dotted(tree, prefix=""):
    """Dotted name -> leaf of a nested dict (``layers.phi_e.w1``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def gnn_params(params, cfg, *, device):
    """The port's :class:`~repro_torch.models.gnn.GNN` of ``cfg`` on
    ``device`` holding the parameters of a nested dict of host arrays
    (the JAX package's GNN parameter tree as numpy, same names and stacked
    ``[L, ...]`` layout), one to one."""
    from repro_torch.models.gnn import GNN
    return _load(GNN(cfg, device=device), params)


def transformer_params(params, cfg, *, device):
    """The port's :class:`~repro_torch.models.transformer.Transformer` of
    ``cfg`` on ``device`` holding a nested dict of host arrays (the JAX
    package's transformer parameter tree as numpy: ``embed``,
    ``final_norm``, stacked ``layers``), one to one.  bf16 leaves
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) pass
    through float32, exact both ways."""
    from repro_torch.models.transformer import Transformer
    return _load(Transformer(cfg, device=device), params)


def adamw_state(state, model, *, device):
    """The port's :class:`~repro_torch.optim.AdamWState` for ``model``'s
    parameters from an AdamW state object of host arrays (``step``, and
    ``mu``/``nu`` nested dicts of the parameter tree's names, e.g. the
    JAX package's ``AdamWState`` as numpy), by dotted name, f32."""
    from repro_torch.optim import AdamWState
    names = [k for k, _ in model.named_parameters()]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    moments = []
    for tree in (state.mu, state.nu):
        flat = _dotted(tree)
        if set(flat) != set(names):
            raise ValueError(f"moment names differ: "
                             f"{sorted(set(flat) ^ set(names))}")
        out = {}
        for k in names:
            arr = np.asarray(flat[k], np.float32)
            if arr.shape != shapes[k]:
                raise ValueError(f"{k}: shape {arr.shape} != {shapes[k]}")
            out[k] = torch.from_numpy(arr.copy()).to(device)
        moments.append(out)
    return AdamWState(int(np.asarray(state.step)), *moments)


def recsys_params(params, cfg, *, device):
    """The port's two-tower parameters (``models.recsys``) of ``cfg`` on
    ``device`` holding a nested tree of host arrays (the JAX package's
    two-tower parameters as numpy: ``tables``, ``item_table`` and the
    ``user_mlp``/``item_mlp`` lists of ``{w, b}``), one to one."""
    from repro_torch.models import recsys
    return _load(recsys.init(cfg, device=device), _lists_as_dicts(params))


def _lists_as_dicts(tree):
    """Lists of subtrees keyed by their index (``user_mlp.0.w``)."""
    if isinstance(tree, (list, tuple)):
        return {str(i): _lists_as_dicts(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _lists_as_dicts(v) for k, v in tree.items()}
    return tree


def _load(model, params):
    """Copy a nested dict of host arrays into ``model``'s parameters of
    the same dotted names and shapes."""
    flat = _dotted(params)
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(flat) ^ set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            if arr.dtype.name == "bfloat16":  # ml_dtypes
                arr = arr.astype(np.float32)
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
    return model
