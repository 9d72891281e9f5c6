"""Config registry of the PyTorch port: the byte-level paper predictors
and the architectures the port runs so far (dense ``qwen3-1.7b``,
``h2o-danube-3-4b``, ``deepseek-7b`` and ``qwen3-14b``, ssm
``mamba2-130m``, hybrid ``zamba2-7b``, moe ``granite-moe-1b-a400m`` and
``qwen3-moe-235b-a22b``; the vlm and encdec families are not ported
yet). The int8 KV cache is a field of
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
]

PREDICTORS = {c.name: c for c in (PRED_TINY, PRED_SMALL, PRED_BASE,
                                  PRED_LARGE)}


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str):
    if arch_id in PREDICTORS:
        return PREDICTORS[arch_id]
    if canon(arch_id) not in ARCH_IDS:
        raise KeyError(f"unknown config {arch_id!r} (choose from "
                       f"{sorted(PREDICTORS) + ARCH_IDS})")
    mod = import_module(f"repro_torch.configs.{canon(arch_id)}")
    return mod.CONFIG
