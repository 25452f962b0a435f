"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built on first
use by :mod:`repro_torch.kernels._build`), each beside its plain PyTorch
version:

- matmul_relu:     relu(W @ X)                      (SSFN LT+NLT forward step;
                                                     serving)
- gram:            G_m = Y_m Y_m^T + I/mu, M workers (layer-0 and direct ADMM
                                                     Gram; training)
- propagate_gram:  Y'_m = relu(W @ Y_m), G_m = Y'_m Y'_m^T + I/mu
                                                    (every training layer l >= 1)
- flash_attention: causal (sliding-window) attention of q, k, v
                   (B, H, S, hd)                    (the model zoo's scoring
                                                     forward)

``csrc/gram.cuh`` holds the Gram tiles that ``gram.cu`` and
``propagate_gram.cu`` share.
"""
