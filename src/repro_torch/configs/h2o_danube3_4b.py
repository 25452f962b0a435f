"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attention="swa",
    window=4096,
    head_dim=120,
    source="arXiv:2401.16818",
)
