"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use to ``build/lib<name>.so`` at
the repository root (``REPRO_TORCH_BUILD`` overrides the directory) for
``sm_90a``.  Nothing here runs when the module is imported: a machine
without ``nvcc`` can import the package and run the plain versions.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero
code, since a refused launch never runs and a later synchronise would not
report it.

The helpers here sit in front of every session-kernel launch (a BiGJoin
epoch makes thousands), so their per-call host cost is kept low: a loaded
library is returned without taking the lock, the stream is read as a raw
handle, and a region descriptor is packed once per distinct set of the
values it is built from (:func:`region_desc`).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

from repro_torch.core import compilestats

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("intersect", "extend", "merge_rank", "fold", "segment_sum",
           "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
DESC = ctypes.c_char_p  # packed little-endian int64 words (region_desc)

# argtypes of every C entry point, by library
SIGNATURES = {
    "intersect": {
        "repro_signed_member": (DESC, I, I, P, I, P, P, I, I, P, P),
    },
    "merge_rank": {
        "repro_rank": (DESC, P, I, P, P, I, P, P, P),
    },
    "extend": {
        "repro_extend": (DESC, DESC, I, I, I, P, P, P, P, P, P, P, P, P, P),
        "repro_extend_scratch": (I, I),
        "repro_extend_lanes": (I, I, I),
    },
    "fold": {
        "repro_commit_fold": (DESC, I, P, P, P, P, P, P, I, P, P, P, P, I,
                              P),
        "repro_commit_fold_scratch": (I, I, I, I),
        "repro_commit_fold_grid": (DESC, I, I, I, I),
        "repro_commit_fold_w": (DESC, I, I, P, P, P, P, P, I, P, P, P, P,
                                I, P),
        "repro_commit_fold_scratch_w": (I, I, I, I, I),
        "repro_commit_fold_grid_w": (DESC, I, I, I, I, I),
    },
    "segment_sum": {
        "repro_segment_sum": (P, I, P, I, I, I, P, P, P),
        "repro_segment_sum_scratch": (I, I),
        "repro_segment_sum_launches": (I,),
    },
    "flash_attention": {
        "repro_flash_prefill": (P, P, P, P, I, I, I, I, I, I, I, I, I, F, F,
                                I, P),
        "repro_flash_decode": (P, P, P, P, I, I, I, I, I, I, I, I, I, F, F,
                               I, I, I, I, I, P, P, P, P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit on the machine that holds the card")
    return exe


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return out.stat().st_mtime < newest


def _nvcc_cmd(name: str, tmp: Path):
    return [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
            str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = SOURCES, force: bool = False
          ) -> Dict[str, str]:
    """Compile the named sources, all ``nvcc`` processes started together.
    Returns each library's compiler output (``-Xptxas -v`` register and
    shared-memory report); raises if any build fails."""
    names = [n for n in names if force or _stale(n)]
    if not names:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing or stale).  A
    library once loaded is returned without taking the lock: entries of
    ``_libs`` are only ever added, each whole.  Building or loading it
    records one compile event (``compilestats``, site ``build.<name>``)."""
    got = _libs.get(name)
    if got is not None:
        return got
    with _lock:
        got = _libs.get(name)
        if got is None:
            compilestats.record(f"build.{name}")
            build([name])
            got = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(got, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            got.repro_error_string.argtypes = [ctypes.c_int]
            got.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = got
        return got


def check(name: str, rc: int) -> None:
    if rc != 0:
        msg = lib(name).repro_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed in {name}: "
                           f"error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (read
    without building a ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t) -> int:
    """A tensor's device address; ``None`` (an absent lo word) is 0."""
    return 0 if t is None else t.data_ptr()


def require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("mixed CPU/CUDA operands to a CUDA kernel")
        if not t.is_contiguous():
            raise ValueError("CUDA kernels take contiguous tensors")


def lo_of(region):
    """A region's composite lo word, or None."""
    return getattr(region, "lo", None)


def uniform_lo(regions) -> bool:
    """True when every region is composite, False when none is; a launch
    that mixes the two layouts is refused."""
    first = None
    for r in regions:
        lo = lo_of(r) is not None
        if first is None:
            first = lo
        elif lo != first:
            raise ValueError("a launch mixes composite (hi, lo) and 1-word "
                             "regions")
    return bool(first)


def desc_key(regions) -> tuple:
    """The values a region descriptor is built from and checked on, region
    by region: the address, dtype and contiguity of key, val and n, the
    key's shape (its capacity), and the lo word's address, dtype, shape and
    contiguity (None when absent).  Two region lists with equal keys have
    equal descriptor words and pass the same checks, so a descriptor cached
    under this key never goes stale.  CPU and CUDA tensors never share an
    address (unified virtual addressing), so the key also fixes the device
    kind.  Flat: fourteen values a region (the lo word's four None when
    absent), so a key of many regions costs the host one tuple."""
    key = []
    for r in regions:
        k, v, n, lo = r.key, r.val, r.n, getattr(r, "lo", None)
        key += (k.data_ptr(), k.dtype, k.shape, k.is_contiguous(),
                v.data_ptr(), v.dtype, v.is_contiguous(),
                n.data_ptr(), n.dtype, n.is_contiguous())
        key += _NO_LO if lo is None else (lo.data_ptr(), lo.dtype, lo.shape,
                                          lo.is_contiguous())
    return tuple(key)


_NO_LO = (None, None, None, None)


_DESCS: Dict[tuple, bytes] = {}
_DESC_CACHE_MAX = 4096  # distinct region sets kept; cleared when full


def region_desc(regions) -> bytes:
    """Host descriptor of sorted regions, packed little-endian: per region
    six int64 words (key pointer, val pointer, n pointer, capacity, key is
    int64, lo pointer or 0).  Cached under :func:`desc_key`; a miss runs
    every check (CUDA, contiguous, int32 val and n, int32/int64 key, an
    int64 lo word shaped like its key) and raises on the first failure, so
    a region that fails one is never cached and raises on every call."""
    key = desc_key(regions)
    got = _DESCS.get(key)
    if got is not None:
        return got
    words = []
    for r in regions:
        require_cuda(r.key, r.val, r.n)
        if r.val.dtype != torch.int32 or r.n.dtype != torch.int32:
            raise ValueError("regions carry int32 val and n")
        if r.key.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"unsupported key dtype {r.key.dtype}")
        lo = lo_of(r)
        if lo is not None:
            require_cuda(lo)
            if lo.dtype != torch.int64 or lo.shape != r.key.shape:
                raise ValueError("a composite lo word is int64 shaped like "
                                 "its key")
        words += [ptr(r.key), ptr(r.val), ptr(r.n), r.key.shape[0],
                  int(r.key.dtype == torch.int64), ptr(lo)]
    got = struct.pack(f"<{max(len(words), 1)}q", *(words or [0]))
    if len(_DESCS) >= _DESC_CACHE_MAX:
        _DESCS.clear()
    _DESCS[key] = got
    return got


def int_array(vals) -> bytes:
    """int64 words packed little-endian, as :func:`region_desc` packs."""
    vals = list(vals) or [0]
    return struct.pack(f"<{len(vals)}q", *vals)
