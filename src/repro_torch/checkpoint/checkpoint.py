"""Fault-tolerant checkpointing of nested dicts of tensors.

The JAX package's on-disk layout:
  * atomic commit — writes go to ``ckpt_<step>.tmp/`` and are renamed only
    after every leaf file and the manifest have been fsynced; a crashed
    writer leaves no half-checkpoint that restore could pick up.
  * manifest — leaf names, dtypes, shapes and a content checksum per leaf
    file; restore verifies before trusting.
  * one ``.npy`` per leaf (its raw bytes), in sorted-key order.
  * retention — keep_last N; the manager restores from the newest intact
    checkpoint, skipping corrupt ones.

Leaves are tensors (restored onto the template leaf's device; bf16 ones
as their raw bits under the dtype name ``bfloat16``, as the JAX package
writes them), numpy
arrays, or Python ints (an optimizer's step counter), in dicts and lists
named as the JAX package names them (``['key']``, ``[0]``), so either
package reads the other's checkpoints; a store snapshot's list of leaves
comes back through :meth:`CheckpointManager.restore_latest_raw`.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path=""):
    """(keystr, leaf) pairs of nested dicts and lists, dict keys sorted at
    every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(template)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            return leaf.detach().view(torch.int16).cpu().numpy()
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):  # a step counter, int32 as the JAX one
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_pytree(tree, directory: str, step: int,
                extra: Optional[dict] = None) -> str:
    """Atomically write one checkpoint; returns its final path."""
    final = os.path.join(directory, f"ckpt_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        # raw-bytes serialization: dtype recorded in the manifest
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, np.frombuffer(arr.tobytes(), np.uint8))
            f.flush()
            os.fsync(f.fileno())
        dtype = "bfloat16" if isinstance(leaf, torch.Tensor) \
            and leaf.dtype == torch.bfloat16 else str(arr.dtype)
        manifest["leaves"].append({
            "name": name, "file": fname, "dtype": dtype,
            "shape": list(arr.shape), "sha": _checksum(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomic commit point
    return final


def load_raw(path: str) -> Tuple[list, dict]:
    """One checkpoint's leaves in saved order, each a verified host array,
    and its manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for rec in manifest["leaves"]:
        raw = np.load(os.path.join(path, rec["file"]))
        try:
            # numpy has no bfloat16: such a leaf comes back as its bits
            dtype = np.int16 if rec["dtype"] == "bfloat16" \
                else rec["dtype"]
            arr = np.frombuffer(raw.tobytes(), np.dtype(dtype)
                                ).reshape(rec["shape"])
        except (TypeError, ValueError) as e:
            raise IOError(f"undecodable leaf {rec['file']}: {e}")
        if _checksum(arr) != rec["sha"]:
            raise IOError(f"checksum mismatch in {rec['file']}")
        leaves.append(arr)
    return leaves, manifest


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(leaf.device)
        return torch.from_numpy(arr.copy()).to(leaf.device)
    if isinstance(leaf, int):
        return int(arr)
    return arr


def load_pytree(template, path: str) -> Tuple[Any, dict]:
    """Restore into the structure of ``template``: a tensor leaf comes back
    as a tensor on the template leaf's device, an int as an int."""
    leaves, manifest = load_raw(path)
    flat_t = _flatten(template)
    if len(flat_t) != len(manifest["leaves"]):
        raise ValueError(
            f"leaf count mismatch: template {len(flat_t)} vs "
            f"checkpoint {len(manifest['leaves'])}")
    return _unflatten(template, [_like(a, t) for a, (_, t) in
                                 zip(leaves, flat_t)]), manifest


def _intact(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "manifest.json"))


class CheckpointManager:
    """save / restore-latest / retention, tolerant of partial writes."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> list:
        out = []
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if name.startswith("ckpt_") and not name.endswith(".tmp") \
                    and _intact(full):
                out.append(int(name.split("_")[1]))
        return out

    def save(self, tree, step: int, extra: Optional[dict] = None) -> str:
        path = save_pytree(tree, self.directory, step, extra)
        self._retain()
        return path

    def _retain(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"ckpt_{s:010d}"), ignore_errors=True)
        # clear stale tmp dirs from crashed writers
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def restore_latest(self, template):
        """Newest intact checkpoint, or None.  Corrupt ones are skipped."""
        for s in reversed(self.all_steps()):
            path = os.path.join(self.directory, f"ckpt_{s:010d}")
            try:
                return load_pytree(template, path)
            except (IOError, ValueError):
                continue
        return None

    def restore_latest_raw(self):
        """Newest intact checkpoint as ``(leaves, manifest)`` — no
        template (see :func:`load_raw`); None when nothing restorable."""
        for s in reversed(self.all_steps()):
            path = os.path.join(self.directory, f"ckpt_{s:010d}")
            try:
                return load_raw(path)
            except (IOError, ValueError):
                continue
        return None
