"""InternVL2-1B: InternViT vision encoder (STUBBED per assignment) +
Qwen2-0.5B-style LM backbone [arXiv:2404.16821].

input_specs supplies precomputed patch embeddings (256 patches, 1024-d);
the LM consumes them through a learned projector."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    num_patches=256,
    patch_dim=1024,
    rope_theta=1e6,
    source="arXiv:2404.16821",
)
