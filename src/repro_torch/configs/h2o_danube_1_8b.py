"""H2O-Danube-1.8B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention="swa",
    window=4096,
    head_dim=80,
    source="arXiv:2401.16818",
)
