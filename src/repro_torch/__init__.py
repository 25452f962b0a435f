"""PyTorch/CUDA port of ``repro``: decentralized layer-wise SSFN with
centralized equivalence (arXiv:2009.13982), trained and served on an
NVIDIA H100; the model zoo (dense, MoE, VLM and audio transformers, the
Zamba2-style hybrid and xLSTM) served and trained (``launch/serve.py``,
``launch/train.py``, ``optim/``); and the layer-wise convex readout over
any of its backbones (``core/readout.py``).

It mirrors ``repro``'s module layout so each ported file has a twin in the
reference.  It imports ``torch``, ``numpy`` and the standard library only;
its hot ops are CUDA kernels written for Hopper (``kernels/csrc/``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
