"""Mistral-Large-Instruct-2407 (123B dense)
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
