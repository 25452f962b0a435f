"""Model-zoo building blocks (port of ``repro/nn``): norms, embeddings,
RoPE, the SwiGLU MLP, GQA attention and the Mamba2 SSM.  MoE and xLSTM
are not ported yet (ROADMAP Queue 1)."""
