"""xLSTM-350M: sLSTM + mLSTM blocks [arXiv:2405.04517].

24 layers, d_model=1024, 4 heads (GQA kv=4 — mLSTM q/k/v are full-head),
d_ff=0 (mixing lives inside the xLSTM blocks), vocab 50304.  One sLSTM
layer per 6-layer period (xLSTM[5:1] ratio)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_period=6,
    ssm_chunk=256,
    source="arXiv:2405.04517",
)
