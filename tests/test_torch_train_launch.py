"""The port's model-zoo training launcher against ``repro``'s on the CPU.

``repro_torch.launch.train.train`` starts from ``repro``'s seeded weights
(``params=``, carried across with ``convert.transformer_params_from_numpy``)
and must reproduce ``repro.launch.train.train``'s data exactly: the same
``TokenStream`` batches and, for a VLM, the same per-step patch draws.
Reduced configs, 3 steps of batch 2 at seq 32; the loss lists agree
within 1e-4 relative, and the ``--checkpoint`` file reads back through
``repro``'s ``load_pytree`` equal to the port's final params.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint import load_pytree as j_load_pytree
from repro.configs import get_config as j_get_config
from repro.launch.train import train as j_train
from repro.models import build_model as j_build_model
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.launch import train as train_lib

ARCHS = {"dense": "h2o_danube3_4b", "vlm": "internvl2_1b"}
RUN = {"steps": 3, "batch": 2, "seq": 32, "log_every": 1}
LOSS_REL = 1e-4


@pytest.fixture(scope="module")
def reference():
    """repro's initial params (numpy) and loss list, per arch."""
    out = {}
    for case, arch in ARCHS.items():
        params = j_build_model(j_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
        out[case] = (params, jax.tree.map(np.asarray, params), j_train(arch, **RUN))
    return out


@pytest.mark.parametrize("case", list(ARCHS))
def test_losses_and_checkpoint_match_reference(case, reference, tmp_path):
    jparams, tree, want = reference[case]
    arch = ARCHS[case]
    params = transformer_params_from_numpy(tree, get_config(arch).reduced(), device="cpu")
    path = str(tmp_path / "final")
    got = train_lib.train(arch, **RUN, device="cpu", params=params, checkpoint_path=path)
    assert isinstance(got, list) and len(got) == RUN["steps"]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)
    # train updates the given params in place; the file holds the final ones.
    back = j_load_pytree(path, jparams)
    for a, b in zip(jax.tree.leaves(back), _tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_cli_trains_and_reports(capsys):
    losses = train_lib.main(["--arch", "stablelm_3b", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--lr", "1e-3", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "final loss" in out


@pytest.mark.parametrize("argv", [
    ["--arch", "nope"],
    ["--arch", "stablelm_3b", "--dist-backend", "mpi"],
    ["--arch", "stablelm_3b", "--steps", "x"],
])
def test_cli_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        train_lib.main(argv)


def test_default_device_is_the_card(monkeypatch):
    """No device means cuda, which raises where CUDA is missing."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lib.train("stablelm_3b", steps=1, batch=1, seq=8)
