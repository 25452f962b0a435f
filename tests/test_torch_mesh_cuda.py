"""``MeshBackend`` on the card: needs an NVIDIA GPU and skips without one.

Like ``tests/test_torch_cuda.py`` this file imports neither JAX nor
``repro``:

    python -m pytest -q --noconftest tests/test_torch_mesh_cuda.py

The reference's sim-vs-mesh train (``tests/test_multidevice.py:166-177``:
M=8 workers of 24 samples, 2 layers of 24, K=60) runs on the card under
three groups: two gloo ranks on one card (each message staged through
pinned host memory), one NCCL rank holding all eight workers, and two
NCCL ranks on two cards (skipped below two GPUs: NCCL refuses two ranks
on one card).  Each holds its readouts and layer costs within 1e-4 of
the card's simulated train (the ranks sum their workers first, then
each other's, and a rank's kernels slice the samples by its own block)
and launches ``gram`` once and ``propagate_gram`` once a later layer on
its own block.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import layerwise, ssfn
from repro_torch.core.backend import MeshBackend, SimulatedBackend
from repro_torch.kernels import gram, propagate_gram
from repro_torch.launch import mesh as mesh_lib

M = 8
GAP = 1e-4
CFG = dict(input_dim=10, num_classes=3, num_layers=2, hidden=24, admm_iters=60)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data():
    rng = np.random.default_rng(5)
    xw = rng.standard_normal((M, CFG["input_dim"], 24)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (M, 24))
    tw = np.eye(CFG["num_classes"], dtype=np.float32)[labels].transpose(0, 2, 1).copy()
    return xw, tw


def _train(backend, device):
    xw, tw = _data()
    xb = backend.shard_workers(torch.from_numpy(xw).to(device))
    tb = backend.shard_workers(torch.from_numpy(tw).to(device))
    gram.reset_launch_count()
    propagate_gram.reset_launch_count()
    params, log = layerwise.train_decentralized_ssfn(
        xb, tb, ssfn.SSFNConfig(**CFG), key=prng.PRNGKey(1), backend=backend)
    torch.cuda.synchronize()
    return ([o.cpu().numpy() for o in params.o], log.layer_costs,
            {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()})


def _mesh_rank(group):
    backend = MeshBackend(group)
    o, costs, launches = _train(backend, group.device)
    return o, costs, launches, backend.describe(), backend.collective_counts()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(per_rank, want):
    want_o, want_costs, _ = want
    for o, costs, launches, _, _ in per_rank:
        assert launches == {"gram": 1, "propagate_gram": CFG["num_layers"]}
        for a, b in zip(o, want_o):
            assert np.isfinite(a).all() and _rel(a, b) < GAP
        np.testing.assert_allclose(costs, want_costs, rtol=GAP)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_train_like_simulated(cuda):
    want = _train(SimulatedBackend(M), cuda)
    per_rank = mesh_lib.spawn_workers(
        _mesh_rank, 2, num_workers=M, backend="gloo", device="cuda", join_timeout_s=300)
    _check(per_rank, want)
    assert all("gloo host-staged" in p[3] for p in per_rank)
    assert all(p[4] == per_rank[0][4] and p[4]["all-reduce"] > 0 for p in per_rank)


@pytest.mark.cuda
def test_one_nccl_rank_holds_every_worker(cuda):
    want = _train(SimulatedBackend(M), cuda)
    group = mesh_lib.make_worker_group(M, backend="nccl", device="cuda")
    got = _mesh_rank(group)
    _check([got], want)
    assert "transport=nccl" in got[3]
    # ExactMean's mixes and the two trace sums are NCCL all-reduces.
    assert got[4]["all-reduce"] == (1 + 2) * CFG["admm_iters"] * (CFG["num_layers"] + 1)


@pytest.mark.cuda
def test_two_nccl_ranks_on_two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL takes one card a rank; this host has one card")
    want = _train(SimulatedBackend(M), cuda)
    per_rank = mesh_lib.spawn_workers(
        _mesh_rank, 2, num_workers=M, backend="nccl", device="cuda", join_timeout_s=300)
    _check(per_rank, want)


@pytest.mark.cuda
def test_nccl_refuses_more_ranks_than_cards(cuda):
    ranks = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh_lib.spawn_workers(_mesh_rank, ranks, num_workers=ranks, backend="nccl",
                               device="cuda")
