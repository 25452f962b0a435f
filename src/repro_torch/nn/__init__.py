"""Model-zoo building blocks (port of ``repro/nn``): norms, embeddings,
RoPE, the SwiGLU MLP, GQA attention, the Mamba2 SSM and the xLSTM cells.
MoE is not ported yet (ROADMAP Queue 1)."""
