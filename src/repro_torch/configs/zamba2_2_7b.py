"""Zamba2-2.7B: Mamba2 backbone + ONE weight-shared attention block invoked
every 6 layers [arXiv:2411.15242].

TPU adaptation (DESIGN.md): the shared attention uses a 4096 sliding
window so the long_500k decode state stays bounded."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=32,
    d_inner=5120,
    shared_attn_period=6,
    attention="swa",
    window=4096,
    head_dim=80,
    source="arXiv:2411.15242",
)
