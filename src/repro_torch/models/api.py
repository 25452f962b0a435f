"""Model factory: family -> model class (port of ``repro/models/api.py``)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.hybrid_model import HybridModel
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.xlstm_model import XLSTMModel


def build_model(cfg: ModelConfig) -> TransformerModel | HybridModel | XLSTMModel:
    if cfg.family == "ssm":
        return XLSTMModel(cfg)
    if cfg.family == "hybrid":
        return HybridModel(cfg)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return TransformerModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
