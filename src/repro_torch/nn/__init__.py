"""Model-zoo building blocks (port of ``repro/nn``): norms, embeddings,
RoPE, the SwiGLU MLP and GQA attention.  MoE, Mamba2 and xLSTM are not
ported yet (ROADMAP Queue 1)."""
