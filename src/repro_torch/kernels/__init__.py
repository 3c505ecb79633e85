"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions.

Every wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version, a CUDA tensor launches the kernel (or raises).  There is
no fallback from one to the other.  Each wrapper adds one to its entry in
:data:`LAUNCHES` per call that launches its kernel, and nowhere else, so a
run can show that its main path went through the kernels.

:data:`VARIANTS_OF` lists each kernel's launch names.  The kernels of the
sorted-region engine (membership, fused extend, merge ranks, commit fold)
have a 1-word and a composite (hi, lo) variant; a launch of the composite
one counts under the kernel's ``_lex`` name.  The commit fold's worker axis
(one launch over every shard of the mesh's store) counts under
``commit_fold_w`` and ``commit_fold_lex_w``.  ``segment_sum`` and
``flash_attention`` have one variant each, their own name.

On ``meta`` tensors (``launch.dryrun``: shapes, no memory) the wrappers of
``flash_attention`` and ``segment_sum`` launch nothing: they return empty
outputs of the kernel's shapes, with the scratch the kernel allocates,
and add the kernel's operation count (each module's ``kernel_ops``, the
count ``chip_smoke.py``'s bound column uses) to :data:`META_OPS`.
"""
from __future__ import annotations

from typing import Dict, Tuple

VARIANTS_OF: Dict[str, Tuple[str, ...]] = {
    name: (name, f"{name}_lex")
    for name in ("signed_member", "member", "fused_extend", "rank_lt_le",
                 "commit_fold")
}
# the commit fold's worker axis (the mesh's sharded store): one launch over
# every worker's shard, 1-word and composite
VARIANTS_OF["commit_fold"] += ("commit_fold_w", "commit_fold_lex_w")
VARIANTS_OF["segment_sum"] = ("segment_sum",)
VARIANTS_OF["flash_attention"] = ("flash_attention",)

KERNELS = tuple(VARIANTS_OF)
VARIANTS = tuple(v for names in VARIANTS_OF.values() for v in names)

LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANTS}


def reset_launches() -> None:
    for name in VARIANTS:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


# kernel operations of the calls made on meta tensors, by kernel
META_OPS: Dict[str, int] = {"flash_attention": 0, "segment_sum": 0}


def reset_meta_ops() -> None:
    for name in META_OPS:
        META_OPS[name] = 0


def count_meta_ops(name: str, ops: int) -> None:
    META_OPS[name] += int(ops)
