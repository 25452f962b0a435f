"""PyTorch/CUDA port of ``repro``: decentralized layer-wise SSFN with
centralized equivalence (arXiv:2009.13982), trained and served on an
NVIDIA H100; the model zoo (dense, MoE, VLM and audio transformers, the
Zamba2-style hybrid and xLSTM) served and trained (``launch/serve.py``,
``launch/train.py``, ``optim/``); the layer-wise convex readout over
any of its backbones (``core/readout.py``); and the dry-run planners that
size the zoo's steps and the readout solve on plans of 256 or 512 H100s
(``launch/dryrun.py``, ``launch/dryrun_dssfn.py``, over
``launch/cost_analysis.py``, ``launch/specs.py`` and ``sharding/``).

It mirrors ``repro``'s module layout so each ported file has a twin in the
reference, but for two: ``repro/kernels/common.py`` (Pallas's interpret
flag and a TPU ``CompilerParams`` shim, which no CUDA kernel needs) and
``repro/testing.py`` (a fallback for a missing ``hypothesis``, which the
tests import from ``repro``; the card's machine has ``hypothesis``).  The
benchmark harness (``benchmarks/bench_*.py``) has no twin yet.  It
imports ``torch``, ``numpy`` and the standard library only; its hot ops
are CUDA kernels written for Hopper (``kernels/csrc/``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
