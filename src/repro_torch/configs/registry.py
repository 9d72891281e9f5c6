"""Config registry of the PyTorch port: the byte-level paper predictors
and the architectures the port runs so far (dense ``qwen3-1.7b``,
``h2o-danube-3-4b``, ``deepseek-7b`` and ``qwen3-14b``, ssm
``mamba2-130m``, hybrid ``zamba2-7b``, moe ``granite-moe-1b-a400m`` and
``qwen3-moe-235b-a22b``, vlm ``llava-next-34b`` and encdec
``whisper-large-v3``: every architecture of the JAX package's registry).
The vlm and encdec configs take their stub frontends' output per
predictor: ``ModelPredictor(..., extra_batch={"img_embeds": ...})`` or
``{"frames": ...}``. The int8 KV cache is a field of
the config, as in the JAX package: ``get_config("deepseek-7b").with_(
kv_cache_dtype="int8")``.

Names resolve with or without dashes (``qwen3-1.7b`` == ``qwen3_1_7b``);
``pred-*`` names resolve to the small predictor LMs of
``configs/paper_predictors.py``.
"""
from __future__ import annotations

from importlib import import_module

from .paper_predictors import PRED_BASE, PRED_LARGE, PRED_SMALL, PRED_TINY

ARCH_IDS = [
    "qwen3_1_7b",
    "h2o_danube_3_4b",
    "deepseek_7b",
    "qwen3_14b",
    "mamba2_130m",
    "zamba2_7b",
    "granite_moe_1b_a400m",
    "qwen3_moe_235b_a22b",
    "llava_next_34b",
    "whisper_large_v3",
]

PREDICTORS = {c.name: c for c in (PRED_TINY, PRED_SMALL, PRED_BASE,
                                  PRED_LARGE)}


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str):
    if arch_id in PREDICTORS:
        return PREDICTORS[arch_id]
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    """The reduced same-family config of an architecture (its
    ``SMOKE_CONFIG``: ``base.tiny_variant``), as the JAX package's
    ``get_smoke_config``; a predictor is its own."""
    if arch_id in PREDICTORS:
        return PREDICTORS[arch_id]
    return _module(arch_id).SMOKE_CONFIG


def _module(arch_id: str):
    if canon(arch_id) not in ARCH_IDS:
        raise KeyError(f"unknown config {arch_id!r} (choose from "
                       f"{sorted(PREDICTORS) + ARCH_IDS})")
    return import_module(f"repro_torch.configs.{canon(arch_id)}")
