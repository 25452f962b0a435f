"""Assigned architecture configs (+ the paper's own SSFN configs).

Every config cites its source in ``source``.  ``get_config(name)`` returns
the full production config; ``get_config(name).reduced()`` the CPU smoke
variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "xlstm_350m",
    "phi35_moe_42b",
    "mistral_large_123b",
    "internvl2_1b",
    "h2o_danube3_4b",
    "h2o_danube_1_8b",
    "mixtral_8x22b",
    "stablelm_3b",
    "zamba2_2_7b",
    "musicgen_medium",
]

ALIASES = {
    "xlstm-350m": "xlstm_350m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "mistral-large-123b": "mistral_large_123b",
    "internvl2-1b": "internvl2_1b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
