"""Model factory: family -> model class.  The dense transformer, the hybrid
(Mamba2 + shared attention) and xLSTM are ported; every other family
raises, naming its ROADMAP item."""
from __future__ import annotations

from repro_torch.models.blocks import unported
from repro_torch.models.config import ModelConfig
from repro_torch.models.hybrid_model import HybridModel
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.xlstm_model import XLSTMModel

_UNPORTED = {
    "moe": ("the MoE transformer", "item 12"),
    "vlm": ("the VLM transformer", "item 12"),
    "audio": ("the audio transformer", "item 12"),
}


def build_model(cfg: ModelConfig) -> TransformerModel | HybridModel | XLSTMModel:
    if cfg.family == "dense":
        return TransformerModel(cfg)
    if cfg.family == "hybrid":
        return HybridModel(cfg)
    if cfg.family == "ssm":
        return XLSTMModel(cfg)
    if cfg.family in _UNPORTED:
        raise unported(*_UNPORTED[cfg.family])
    raise ValueError(f"unknown family {cfg.family!r}")
