"""The twins of ``repro``'s model-zoo examples (``examples/torch_port/
{layerwise_readout,serve_decode,train_lm}.py``) on the CPU, against the
stdout ``repro``'s scripts print (``tests/torch_examples_record.py``).

``layerwise_readout``'s and ``train_lm``'s ``run`` take ``repro``'s own
seeded weights, carried across with
``convert.transformer_params_from_numpy``; ``train_lm`` at the recorded
``--steps 2 --batch 1 --seq 32``.  Bars (the port's tests of the same
functions): readout costs 1e-4 relative, train accuracies exact, the M=4
gap 1e-4; the step-0 loss 1e-5 and the step-1 loss 1e-4 relative; the
served dSSFN stack's accuracy, request, lowering and batch counts exact;
each plus half a unit of the last printed digit.  The zoo models' greedy
tokens are held by ``test_torch_launch.py``; here ``serve_decode``'s
``main`` runs at its default size and passes its own asserts.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

import torch_examples_record as rec
from repro.configs import get_config as j_get_config
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import build_model

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def repro_weights(jcfg, cfg):
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    return transformer_params_from_numpy(tree, cfg, device="cpu")


def held(check, out, capsys):
    checks = rec.Checks()
    check(checks, out, capsys.readouterr().out.splitlines())
    assert not checks.failed(), checks.failed()


def test_layerwise_readout_with_repros_weights(capsys):
    twin = rec.load_twin("layerwise_readout")
    jcfg = j_get_config("stablelm_3b").reduced(layers=4, d_model=128)
    cfg = get_config("stablelm_3b").reduced(layers=4, d_model=128)
    out = twin.run(build_model(cfg), repro_weights(jcfg, cfg), CPU)
    held(rec.check_layerwise_readout, out, capsys)


def test_serve_dssfn_stack_serves_repros_stack(capsys):
    out = rec.load_twin("serve_decode").serve_dssfn_stack(CPU)
    held(rec.check_serve_dssfn, out, capsys)


def test_serve_decode_main_at_its_default_size(capsys):
    out = rec.load_twin("serve_decode").main(["--device", "cpu"])
    assert sorted(out["served"]) == ["h2o_danube3_4b", "xlstm_350m", "zamba2_2_7b"]
    for res in out["served"].values():
        assert res["tokens"].shape == (4, 16) and res["device"] == "cpu"
    held(rec.check_serve_dssfn, out["dssfn"], capsys)


def test_train_lm_with_repros_weights(capsys):
    twin = rec.load_twin("train_lm")
    jcfg = JModelConfig(**{f: getattr(twin.CFG, f) for f in twin.CFG.__dataclass_fields__})
    assert rec.ARGS["train_lm"] == ["--steps", "2", "--batch", "1", "--seq", "32"]
    args = argparse.Namespace(steps=2, batch=1, seq=32)
    out = twin.run(args, CPU, params=repro_weights(jcfg, twin.CFG))
    held(rec.check_train_lm, out, capsys)
