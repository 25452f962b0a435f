"""Launchers: ``train_dssfn``, ``serve_dssfn`` and ``lint_dssfn`` for the
paper's net, ``train`` and ``serve`` for the model zoo, ``mesh`` (the
worker groups of ``MeshBackend`` and ``core/readout.py``, and the plans of
the production meshes), and the dry runs ``dryrun`` (the zoo) and
``dryrun_dssfn`` (the readout solve) over ``specs`` and ``cost_analysis``."""
