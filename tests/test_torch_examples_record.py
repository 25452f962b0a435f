"""The store of ``repro``'s example output and the twins' contract.

The stored stdout under ``tests/data/torch_examples_repro/`` is what
``repro``'s scripts print here: ``examples/gossip_vs_spectral_gap.py``,
which prints no time, is run live and must print the stored file line for
line.  Every twin in ``examples/torch_port/`` imports neither ``jax`` nor
``repro``, and without CUDA its ``main`` raises with the ``--device cpu``
remedy (its default device is ``cuda``).
"""
import ast
import os

import pytest
import torch

import torch_examples_record as rec


def test_stored_stdout_is_what_repro_prints():
    live = rec.run_repro("gossip_vs_spectral_gap").splitlines()
    assert live == rec.stored("gossip_vs_spectral_gap")


def test_every_script_has_a_record_and_a_twin():
    scripts = sorted(f[:-3] for f in os.listdir(os.path.join(rec.ROOT, "examples"))
                     if f.endswith(".py"))
    twins = sorted(f[:-3] for f in os.listdir(rec.TWINS) if f.endswith(".py"))
    assert scripts == twins == sorted(rec.ARGS)
    for name in scripts:
        assert rec.stored(name), name
        with open(os.path.join(rec.DATA, f"{name}.txt")) as f:
            assert f.readline().rstrip("\n") == rec.header(name)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("name", sorted(rec.ARGS))
def test_twin_imports_no_jax_and_no_repro(name):
    roots = set(_imported_roots(os.path.join(rec.TWINS, f"{name}.py")))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
@pytest.mark.parametrize("name", sorted(rec.ARGS))
def test_twin_refuses_cuda_without_a_card(name, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        rec.load_twin(name).main(argv)


@pytest.mark.parametrize("token,half", [("0.873", 5e-4), ("2.5e-03", 5e-5), ("81,619,200", 0.5),
                                        ("7.92e-03", 5e-6), ("10", 0.5), ("1e-06", 5e-7)])
def test_half_unit_of_the_last_printed_digit(token, half):
    assert rec.half_unit(token) == pytest.approx(half)
