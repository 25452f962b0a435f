"""The check that decides ``correct``: the reference against the port, the
control and the planted faults against the limits, at a tiny size."""
import math
import time

import pytest
import torch
from conftest import POLICIES, TINY, TINY_LIMITS

from portbench.drivers import dssfn_train
from portbench.harness import check, faults, inputs, program
from portbench.reference import dssfn_ref, mixing
from portbench.reference.mixing import ring_gossip

SEEDS = (1, 2, 3)


def _gaps(out, ref, job):
    return check.gaps(out, ref, job.r, job.x_test, logits=dssfn_ref.logits)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_holds_the_port_and_fails_its_control(tiny_cell, policy, seed):
    cell = tiny_cell(policy)
    spec = program.train_spec(TINY, cell.traffic)
    job = inputs.make(TINY, seed, 0, "cpu")
    ref = dssfn_train.reference_result(cell, job)
    sound = _gaps(program.train(spec, job), ref, job)
    within, _ = check.judge(sound, TINY_LIMITS)
    assert within, sound
    low = dssfn_train.reference_result(cell, job, dtype=torch.float32, tf32=True)
    control = _gaps(check.Outputs(tuple(low.readouts), low.objective.numpy()), ref, job)
    within, _ = check.judge(control, TINY_LIMITS)
    assert not within, control


def test_mixing_rules_are_the_ring_power_and_the_mean():
    h = ring_gossip.matrix(5, rounds=3, degree=1)
    c = torch.zeros(5, 5, dtype=torch.float64)
    for i in range(5):
        c[i, i] = c[i, (i + 1) % 5] = c[i, (i - 1) % 5] = 1 / 3
    torch.testing.assert_close(h, c @ c @ c)
    torch.testing.assert_close(h.sum(dim=0), torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ring_gossip.matrix(5, rounds=3, degree=3)
    sent = torch.randn(5, 2, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    gossip = mixing.make({"rule": "ring_gossip", "rounds": 3, "degree": 1}, 5,
                         device="cpu", dtype=torch.float64)
    torch.testing.assert_close(gossip(sent, 0, 0), torch.einsum("mj,jqd->mqd", h, sent))
    mean = mixing.make({"rule": "mean"}, 5, device="cpu", dtype=torch.float64)
    torch.testing.assert_close(mean(sent, 0, 0), sent.mean(dim=0, keepdim=True).expand_as(sent))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11 + 2.0 ** -13, -3.0])
    got = dssfn_ref.round_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, -3.0]


def test_inputs_repeat_for_a_seed_and_differ_between_trains():
    a = inputs.make(TINY, 2**31 + 7, 0, "cpu")
    b = inputs.make(TINY, 2**31 + 7, 0, "cpu")
    c = inputs.make(TINY, 2**31 + 7, 1, "cpu")
    for left, right in zip(a, b):
        if isinstance(left, tuple):
            assert all(torch.equal(x, y) for x, y in zip(left, right))
        else:
            assert torch.equal(left, right)
    assert not torch.equal(a.x_workers, c.x_workers)
    m, p, jm = a.x_workers.shape
    assert (m, p, jm) == (TINY["workers"], TINY["input_dim"], TINY["num_train"] // TINY["workers"])
    assert torch.equal(a.t_workers.sum(dim=1), torch.ones(m, jm))
    assert [tuple(r.shape) for r in a.r] == [(20, 12), (20, 26), (20, 26)]


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_a_run_with_a_fault_underneath_is_not_correct(tiny_cell, policy, fault):
    """The whole run but its look for a card, the timed path broken
    underneath by each fault a cell can have."""
    cell = tiny_cell(policy)
    seed = 2**31 + 11
    if fault is None:
        line = dssfn_train.run(cell, seed=seed, seconds=0.2, trace=False,
                          device=torch.device("cpu"), started=time.perf_counter())
        assert line["correct"] is True
        return
    spec = program.train_spec(cell.config, cell.traffic)
    with faults.planted(fault, spec.resolve_policy()):
        line = dssfn_train.run(cell, seed=seed, seconds=0.2, trace=False,
                          device=torch.device("cpu"), started=time.perf_counter())
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


def test_outputs_of_another_shape_never_pass(tiny_cell):
    job = inputs.make(TINY, 5, 0, "cpu")
    ref = dssfn_train.reference_result(tiny_cell("exact"), job)
    out = check.Outputs(tuple(ref.readouts[:-1]), ref.objective.numpy()[:-1])
    assert all(math.isinf(v) for v in _gaps(out, ref, job).values())


def test_non_finite_outputs_count_as_failed(tiny_cell):
    job = inputs.make(TINY, 5, 0, "cpu")
    ref = dssfn_train.reference_result(tiny_cell("exact"), job)
    readouts = list(ref.readouts)
    readouts[1] = readouts[1].clone()
    readouts[1][0, 0] = float("nan")
    out = check.Outputs(tuple(readouts), ref.objective.numpy())
    assert not check.finite(out)
    assert check.finite(check.Outputs(tuple(ref.readouts), ref.objective.numpy()))
