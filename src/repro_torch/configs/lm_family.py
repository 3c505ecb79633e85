"""LM-family ArchSpec: the serving and training shapes of the
assigned LM archs and their analytic model FLOPs.

The family serves on the port (``models.transformer``: prefill and
KV-cache decode); its training step and smoke run are a later slice, so
``smoke_run`` is None and the archs are not in ``registry.get_arch`` yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256, microbatches=8),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, shard_seq=True),
}


def lm_arch(arch_id: str, describe: str, full: TransformerConfig,
            smoke: TransformerConfig) -> ArchSpec:
    def model_flops(shape_name: str) -> float:
        shape = SHAPES[shape_name]
        n_active = full.active_param_count()
        tokens = shape["batch"] * (shape["seq"]
                                   if shape["kind"] != "decode" else 1)
        factor = 6.0 if shape["kind"] == "train" else 2.0
        return factor * n_active * tokens

    return ArchSpec(arch_id, "lm", describe, full, smoke, None, model_flops)
