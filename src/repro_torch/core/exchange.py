"""The exchanges between the workers of a mesh: the only code that moves
data across the worker axis.

A rank of a :class:`~repro_torch.launch.mesh.WorkerMesh` holds ``wl = w /
R`` workers as the leading ``[wl]`` axis of its tensors.  With one rank
(``mesh.ranks == 1``) every exchange is local and no collective is
called: :func:`all_to_all` is a transpose of the ``[w_src,
w_dst, cap, ...]`` send buffers, :func:`psum` and :func:`pmax` a sum and a
max over dim 0.  With R ranks each is ONE collective over the default
process group: the send buffers regrouped by destination rank through
``all_to_all_single``, or the local reduction ``all_reduce``-d.  Every
reduced tensor is an integer one (gloo has no bool reduction).

gloo takes CUDA tensors in these collectives (torch 2.11 on the H100
machine; it copies them through host memory itself), so tensors stay on
their device whatever the backend, and no branch here stages them.

Three more exchanges move whole leaves and host objects between rank 0
and the others, for snapshots, restores and the serving pool's schedule:
:func:`gather_to_root` (every rank's ``[wl, ...]`` rows to rank 0 as
``[w, ...]``), :func:`scatter_from_root` (rank 0's ``[w, ...]`` to each
rank's span) and :func:`broadcast_object` (a small picklable object from
rank 0).  With one rank each is the identity and calls no collective.

``EXCHANGE_BYTES`` counts, per kind, the bytes this rank hands to other
ranks: the blocks of an ``all_to_all`` addressed to workers of other
ranks, a reduced or gathered tensor once for each other rank, a rank's
rows sent to rank 0, and rank 0's spans and broadcast payload once for
each other rank.  With
``TIMING[0]`` set, ``EXCHANGE_SECONDS`` adds the host time of each
exchange between two device synchronizations: the collective with R
ranks, the transpose or the reduction with one, so a one-process run
carries the synchronizations a ranked run does (off by default: they
cost a round trip each).
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import WorkerMesh

KINDS = ("all_to_all", "psum", "pmax", "gather", "gather_root",
         "scatter_root", "broadcast")
EXCHANGE_BYTES: Dict[str, int] = dict.fromkeys(KINDS, 0)
EXCHANGE_SECONDS: Dict[str, float] = dict.fromkeys(KINDS, 0.0)
TIMING = [False]


def reset_counters() -> None:
    for k in KINDS:
        EXCHANGE_BYTES[k] = 0
        EXCHANGE_SECONDS[k] = 0.0


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(kind: str, nbytes: int, t: torch.Tensor, call):
    """Run one exchange and return what it returns, counting its bytes
    (and its time when ``TIMING[0]``)."""
    EXCHANGE_BYTES[kind] += int(nbytes)
    if not TIMING[0]:
        return call()
    _sync(t)
    t0 = time.perf_counter()
    out = call()
    _sync(t)
    EXCHANGE_SECONDS[kind] += time.perf_counter() - t0
    return out


def all_to_all(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """[wl_src, w·cap, ...] send buffers -> [wl_dst, w·cap, ...] received
    ones: block j of worker i's buffer arrives as block i of worker j's
    (``jax.lax.all_to_all`` with split and concat axis 0)."""
    R = mesh.ranks
    if R == 1:
        w = x.shape[0]
        return _timed("all_to_all", 0, x, lambda: x.reshape(
            (w, w, -1) + x.shape[2:]).transpose(0, 1).reshape(x.shape))
    import torch.distributed as dist
    wl = x.shape[0]
    # [wl_src, R_dst, wl_dst, cap, ...] -> chunks by destination rank
    send = x.reshape((wl, R, wl, -1) + x.shape[2:]).transpose(0, 1) \
        .contiguous()
    recv = torch.empty_like(send)  # [R_src, wl_src, wl_dst, cap, ...]
    _timed("all_to_all", send.nbytes * (R - 1) // R, send,
           lambda: dist.all_to_all_single(recv, send))
    return recv.permute((2, 0, 1) + tuple(range(3, recv.dim()))) \
        .reshape(x.shape)


def _all_reduce(kind: str, x: torch.Tensor, mesh: WorkerMesh,
                op: str) -> torch.Tensor:
    """Reduce dim 0 of ``x`` here (``op`` SUM or MAX), then over the
    ranks."""
    def local():
        return x.sum(0) if op == "SUM" else x.amax(0)
    R = mesh.ranks
    if R == 1:
        return _timed(kind, 0, x, local)
    s = local()
    if s.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"the mesh reduces int32 or int64 tensors, got "
                        f"{s.dtype}")
    import torch.distributed as dist
    _timed(kind, s.nbytes * (R - 1), s,
           lambda: dist.all_reduce(s, op=getattr(dist.ReduceOp, op)))
    return s


def psum(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """Sum over every worker of the mesh (dim 0 of each rank's tensor)."""
    return _all_reduce("psum", x, mesh, "SUM")


def pmax(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """Max over every worker of the mesh (dim 0 of each rank's tensor)."""
    return _all_reduce("pmax", x, mesh, "MAX")


def any_worker(bits: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """OR of a bool tensor over the ranks (identity with one rank)."""
    if mesh.ranks == 1:
        return bits
    return pmax(bits.to(torch.int32)[None], mesh) > 0


def _all_gather(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    import torch.distributed as dist
    R = mesh.ranks
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(R)]
    _timed("gather", x.nbytes * (R - 1), x,
           lambda: dist.all_gather(parts, x))
    return torch.cat(parts)


def worker_counts(n: torch.Tensor, mesh: WorkerMesh) -> np.ndarray:
    """The [w] int64 host vector of a per-worker count ``n`` [wl]: every
    rank reads the same global numbers."""
    if mesh.ranks > 1:
        n = _all_gather(n.to(torch.int64), mesh)
    return n.cpu().numpy().astype(np.int64)


def gather_rows(n: torch.Tensor, tensors: Sequence[torch.Tensor],
                mesh: WorkerMesh) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Every worker's first ``n[i]`` rows of each [wl, cap, ...] tensor, on
    the host in worker order, the same on every rank: (ns [w] int64, one
    concatenated array a tensor).  With R ranks the sizes are gathered
    first, then each tensor's rows up to the largest size (no second
    collective when every worker has none)."""
    ns = worker_counts(n, mesh)
    if mesh.ranks > 1:
        m = int(ns.max())
        tensors = [_all_gather(t[:, :m], mesh) if m else
                   t.new_empty((ns.shape[0], 0) + t.shape[2:])
                   for t in tensors]
    outs = []
    for t in tensors:
        a = t.cpu().numpy()
        outs.append(np.concatenate([a[i, :k] for i, k in enumerate(ns)]))
    return ns, outs


def per_rank(value: int, mesh: WorkerMesh) -> List[int]:
    """One host integer of each rank, in rank order, on every rank."""
    if mesh.ranks == 1:
        return [int(value)]
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=torch.device(mesh.device))
    return [int(v) for v in _all_gather(t, mesh).tolist()]


def gather_to_root(x: torch.Tensor, mesh: WorkerMesh
                   ) -> Optional[torch.Tensor]:
    """Every rank's [wl, ...] rows of one leaf, stacked in worker order
    as [w, ...] on rank 0's device; ``None`` on the other ranks (ONE
    ``gather``).  With one rank, ``x`` itself."""
    R = mesh.ranks
    if R == 1:
        return _timed("gather_root", 0, x, lambda: x)
    import torch.distributed as dist
    x = x.contiguous()
    root = mesh.rank == 0
    out = x.new_empty((x.shape[0] * R,) + x.shape[1:]) if root else None
    parts = list(out.split(x.shape[0])) if root else None
    _timed("gather_root", 0 if root else x.nbytes, x,
           lambda: dist.gather(x, parts, dst=0))
    return out


def scatter_from_root(leaf, shape: Sequence[int], dtype: torch.dtype,
                      mesh: WorkerMesh) -> torch.Tensor:
    """Rank 0's host leaf [w, ...] (``leaf``, read on rank 0 only) put on
    the device, and each rank's span of its rows, [wl, ...] of ``shape``
    and ``dtype``, returned on that rank's device (ONE ``scatter``).
    With one rank, the leaf on the device."""
    dev = torch.device(mesh.device)
    R = mesh.ranks
    if R == 1:
        t = torch.tensor(np.asarray(leaf), device=dev)
        return _timed("scatter_root", 0, t, lambda: t)
    import torch.distributed as dist
    wl = int(shape[0]) // R
    out = torch.empty((wl,) + tuple(shape[1:]), dtype=dtype, device=dev)
    parts = None
    if mesh.rank == 0:
        whole = torch.tensor(np.asarray(leaf), device=dev)
        if tuple(whole.shape) != tuple(shape) or whole.dtype != dtype:
            raise ValueError(f"leaf of {tuple(whole.shape)} {whole.dtype}, "
                             f"not {tuple(shape)} {dtype}")
        parts = list(whole.split(wl))
    _timed("scatter_root", out.nbytes * (R - 1) if mesh.rank == 0 else 0,
           out, lambda: dist.scatter(out, parts, src=0))
    return out


def broadcast_object(obj: Any, mesh: WorkerMesh) -> Any:
    """Rank 0's ``obj`` (picklable, small) on every rank; the other ranks'
    argument is ignored.  Its size, then its bytes, as int64 and uint8
    tensors on the mesh's device.  With one rank, ``obj``."""
    R = mesh.ranks
    dev = torch.device(mesh.device)
    if R == 1:
        return obj
    import torch.distributed as dist
    root = mesh.rank == 0
    blob = pickle.dumps(obj) if root else b""
    n = torch.tensor([len(blob)], dtype=torch.int64, device=dev)

    def call():
        dist.broadcast(n, src=0)
        data = torch.frombuffer(bytearray(blob), dtype=torch.uint8) \
            .to(dev) if root else \
            torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
        dist.broadcast(data, src=0)
        return data
    data = _timed("broadcast", (len(blob) + n.nbytes) * (R - 1)
                  if root else 0, n, call)
    return obj if root else pickle.loads(data.cpu().numpy().tobytes())
