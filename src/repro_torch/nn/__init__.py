"""Model-zoo building blocks (port of ``repro/nn``): norms, embeddings,
RoPE, the SwiGLU MLP, the MoE FFN, GQA attention, the Mamba2 SSM and the
xLSTM cells."""
