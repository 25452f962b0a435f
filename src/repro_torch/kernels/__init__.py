"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built on first
use by :mod:`repro_torch.kernels._build`), each beside its plain PyTorch
version:

- matmul_relu:     relu(W @ X)            (SSFN LT+NLT forward step)
"""
