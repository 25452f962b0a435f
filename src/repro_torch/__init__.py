"""PyTorch/CUDA port of ``repro``: decentralized layer-wise SSFN with
centralized equivalence (arXiv:2009.13982), served on an NVIDIA H100.

It mirrors ``repro``'s module layout so each ported file has a twin in the
reference.  It imports ``torch``, ``numpy`` and the standard library only;
its hot op, ``relu(W @ y)``, is a CUDA kernel written for Hopper
(``kernels/csrc/matmul_relu.cu``).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
