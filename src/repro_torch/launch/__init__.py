"""Launchers: ``train_dssfn``, ``serve_dssfn`` and ``lint_dssfn`` for the
paper's net, ``train`` and ``serve`` for the model zoo, and ``mesh`` (the
worker groups of ``MeshBackend`` and ``core/readout.py``)."""
