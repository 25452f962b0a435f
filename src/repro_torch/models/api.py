"""Model factory: family -> model class.  Only the dense transformer is
ported; every other family raises, naming its ROADMAP item."""
from __future__ import annotations

from repro_torch.models.blocks import unported
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerModel

_UNPORTED = {
    "hybrid": ("the hybrid (Mamba2 + shared attention) model", "item 10"),
    "ssm": ("the xLSTM model", "item 11"),
    "moe": ("the MoE transformer", "item 12"),
    "vlm": ("the VLM transformer", "item 12"),
    "audio": ("the audio transformer", "item 12"),
}


def build_model(cfg: ModelConfig) -> TransformerModel:
    if cfg.family == "dense":
        return TransformerModel(cfg)
    if cfg.family in _UNPORTED:
        raise unported(*_UNPORTED[cfg.family])
    raise ValueError(f"unknown family {cfg.family!r}")
