"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built on first
use by :mod:`repro_torch.kernels._build`), each beside its plain PyTorch
version:

- matmul_relu:     relu(W @ X)                      (SSFN LT+NLT forward step;
                                                     serving)
- gram:            G_m = Y_m Y_m^T + I/mu, M workers (layer-0 and direct ADMM
                                                     Gram; training)
- propagate_gram:  Y'_m = relu(W @ Y_m), G_m = Y'_m Y'_m^T + I/mu
                                                    (every training layer l >= 1)
- flash_attention: causal (sliding-window) attention of q (B, H, S, hd)
                   over k, v (B, H_kv, S, hd)       (the model zoo's scoring
                                                     forward)
- ssm_scan:        the Mamba2 chunked scan of x (B, S, H, dh) from a zero
                   state, returning y and the final (B, H, dh, ds) state
                                                    (the hybrid's scoring
                                                     forward)
- mlstm_scan:      the chunked stabilized mLSTM of q, k (B, S, H, dk) and
                   v (B, S, H, dv) from the zero state, returning y and
                   the final (C, n, m)              (xLSTM's scoring
                                                     forward)

No op has a backward (nor has ``repro``'s): each refuses tensors that
require grad while grad mode is on (``_autograd.refuse_grad``), on the
CPU route as on the card, so training takes the plain path.

``csrc/gram.cuh`` holds the Gram tiles that ``gram.cu`` and
``propagate_gram.cu`` share; ``csrc/tensor_core.cuh`` the ``mma.sync``,
``ldmatrix`` and ``cp.async`` wrappers of ``flash_attention.cu``'s bf16
instance.
"""
