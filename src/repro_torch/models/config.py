"""Unified model configuration covering all assigned architecture families.

Port of ``repro/models/config.py``: the same fields and properties, with
``torch_dtype`` in place of ``jnp_dtype``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.nn.layers import round_up


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # attention
    attention: str = "full"        # full | swa
    window: int = 4096
    rope_theta: float = 1e4
    # moe
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    d_inner: int = 0
    conv_kernel: int = 4
    shared_attn_period: int = 0    # hybrid: shared attn block every k layers
    # xlstm
    slstm_period: int = 0          # every k-th layer is sLSTM (0 = none)
    # modality stubs
    num_patches: int = 0           # vlm: visual prefix length
    patch_dim: int = 1024          # vlm: stubbed vision-encoder output dim
    num_codebooks: int = 0         # audio: EnCodec codebooks
    # numerics / runtime
    dtype: str = "bfloat16"
    attn_chunk: int = 1024
    ssm_chunk: int = 256
    remat: bool = True
    # Block (sqrt-L) rematerialization: checkpoint only every k-th layer
    # boundary, recomputing k layers per backward group.  0 = per-layer.
    remat_block: int = 0
    # Route the full-sequence, cache-free attention through the port's
    # flash_attention op: the hand-written CUDA kernel for CUDA tensors (at
    # every sequence length), its plain version for CPU tensors.  Off, the
    # chunked online-softmax attention runs.  Prefill and decode never take
    # it, as in the reference.  The SSM and mLSTM scans are not ported yet.
    use_pallas_kernels: bool = False
    tie_embeddings: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh axis."""
        return round_up(self.vocab_size, 256)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: bounded per-token state."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention == "swa"

    @property
    def d_inner_eff(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    def reduced(self, *, layers: int = 2, d_model: int = 256) -> "ModelConfig":
        """Smoke-test variant: same family/block structure, tiny dims."""
        heads = max(2, min(4, self.num_heads))
        kv = min(self.num_kv_heads, heads)
        period = self.shared_attn_period or self.slstm_period
        if period:
            layers = max(layers, period)  # keep >=1 special layer in the pattern
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=2 * d_model if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=heads if self.ssm_heads else 0,
            d_inner=2 * d_model if self.family in ("ssm", "hybrid") else 0,
            window=64,
            num_patches=8 if self.num_patches else 0,
            patch_dim=64 if self.num_patches else self.patch_dim,
            attn_chunk=32,
            ssm_chunk=16,
            dtype="float32",
            remat=False,
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v, l = self.d_model, self.padded_vocab, self.num_layers
        hd = self.hd
        n = v * d  # embed
        if self.family == "audio":
            n = self.num_codebooks * v * d
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.num_experts:
            moe = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            mlp = 0
        if self.family == "ssm" and self.slstm_period:
            # xlstm: mLSTM qkv+gates+out, sLSTM 4 gates + recurrent
            di = d
            mlstm = 3 * d * di + 2 * d * self.num_heads + di * d
            slstm = 4 * d * d + 4 * d * (d // self.num_heads)
            n_slstm = l // self.slstm_period
            n += (l - n_slstm) * mlstm + n_slstm * slstm + 2 * l * d
        elif self.family == "hybrid":
            di = self.d_inner_eff
            mamba = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d
            n += l * (mamba + 2 * d) + (attn + mlp + 4 * d)  # one shared block
        else:
            n += l * (attn + mlp + moe + 2 * d)
        n += d * v  # lm head
        if self.family == "audio":
            n += d * v * (self.num_codebooks - 1)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        expert_params = self.num_layers * self.num_experts * 3 * self.d_model * self.d_ff
        active = self.num_layers * self.top_k * 3 * self.d_model * self.d_ff
        return total - expert_params + active
