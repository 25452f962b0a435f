"""MusicGen-medium: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

The EnCodec audio codec is STUBBED per assignment: input_specs provides
the (B, S, 4) codebook-token grid; the model implements the 4-codebook
sum-embedding and per-codebook output heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    source="arXiv:2306.05284",
)
