"""The twins of ``repro``'s dSSFN examples (``examples/torch_port/
{quickstart,gossip_vs_spectral_gap,robust_networks}.py``) at their default
sizes on the CPU, against the stdout ``repro``'s scripts print
(``tests/torch_examples_record.py``).

Each twin's printed lines have the stored lines' format (numbers aside),
and each printed number of the store is held to the twin's full-precision
value within the bar the port's tests hold the same function to, plus
half a unit of its last printed digit (``torch_examples_record.BARS``):
spectral gaps, B, B* and eq.-15 scalars exact; quickstart's layer costs
1e-4 relative, its accuracies and decision agreement one test sample's
flip; gossip errors 1e-6 x err0 (``examples/gossip_vs_spectral_gap.py``'s
noise floor); ``robust_networks``' relative errors 1e-4 (``o_star``'s
bar, ``tests/test_torch_policies.py``) and within a factor of 10 of the
stored value (five of the nine lines read below 2e-5).  Wall times are
not compared.
"""
import pytest
import torch

import torch_examples_record as rec


@pytest.fixture(autouse=True)
def one_thread():
    """Small eager ops run fastest on one thread (the test workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["quickstart", "gossip_vs_spectral_gap", "robust_networks"])
def test_twin_prints_repros_numbers(name, capsys):
    out = rec.load_twin(name).main(["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    checks = rec.Checks()
    getattr(rec, f"check_{name}")(checks, out, printed)
    assert not checks.failed(), checks.failed()
    assert len(checks.records) > 5
