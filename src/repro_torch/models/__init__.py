from repro_torch.models.api import build_model
from repro_torch.models.config import ModelConfig

__all__ = ["build_model", "ModelConfig"]
