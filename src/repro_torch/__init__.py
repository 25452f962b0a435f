"""PyTorch/CUDA port of ``repro``: decentralized layer-wise SSFN with
centralized equivalence (arXiv:2009.13982), trained and served on an
NVIDIA H100, and the model zoo's dense transformers for inference.

It mirrors ``repro``'s module layout so each ported file has a twin in the
reference.  It imports ``torch``, ``numpy`` and the standard library only;
its hot ops are CUDA kernels written for Hopper (``kernels/csrc/``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
