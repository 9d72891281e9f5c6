"""Config registry of the PyTorch port: the byte-level paper predictors
and the architectures the port runs so far (dense ``qwen3-1.7b``, ssm
``mamba2-130m``, hybrid ``zamba2-7b``).

Names resolve with or without dashes (``qwen3-1.7b`` == ``qwen3_1_7b``);
``pred-*`` names resolve to the small predictor LMs of
``configs/paper_predictors.py``.
"""
from __future__ import annotations

from importlib import import_module

from .paper_predictors import PRED_BASE, PRED_LARGE, PRED_SMALL, PRED_TINY

ARCH_IDS = [
    "qwen3_1_7b",
    "mamba2_130m",
    "zamba2_7b",
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
