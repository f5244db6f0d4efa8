"""Config registry: ``get_config(name)`` / ``list_configs()``.

A copy of ``repro.configs``: the ten assigned architectures (public-
literature configs, sources in each file), every one of which the port's
LM path runs.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable  # noqa: F401

ARCH_IDS = [
    "qwen2-vl-2b",
    "falcon-mamba-7b",
    "hubert-xlarge",
    "grok-1-314b",
    "llama4-scout-17b-16e",
    "internlm2-1.8b",
    "h2o-danube-1.8b",
    "llama3-8b",
    "qwen1.5-4b",
    "jamba-v0.1-52b",
]

_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "hubert-xlarge": "hubert_xlarge",
    "grok-1-314b": "grok_1_314b",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "internlm2-1.8b": "internlm2_1_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_configs() -> List[str]:
    return list(ARCH_IDS)
