"""The port's readout dry run (``launch/dryrun_dssfn.py``) on the CPU: the
counting transport's counts and bytes against a real 2-rank gloo
``WorkerGroup``'s ``Transport.stats`` for both schedules, the one-rank
solve against the simulated solve of ranks that hold the same block
(within the readout's 1e-4 bar), and the CLI with its FLOP and
collective formulas.

``repro.launch.dryrun_dssfn`` is never imported here: it sets XLA_FLAGS
for 512 host devices when imported.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import admm, readout
from repro_torch.launch import dryrun_dssfn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.cost_analysis import CountingTransport

READOUT_REL = 1e-4
N, Q, J, K = 64, 4, 48, 6


def _blocks(ranks, seed=0, j=J):
    g = np.random.default_rng(seed)
    return (g.standard_normal((N, j * ranks)).astype(np.float32),
            g.standard_normal((Q, j * ranks)).astype(np.float32))


def _both_modes(group, y, t):
    """Each schedule on this rank's block of ``group``; the transport's
    counts and bytes of each."""
    rows = slice(group.rank * J, (group.rank + 1) * J)
    yl, tl = torch.from_numpy(y[:, rows]), torch.from_numpy(t[:, rows])
    out = {}
    for mode in dryrun_dssfn.MODES:
        group.transport.reset()
        dryrun_dssfn._solver(mode, q=Q, iters=K, transport=group)(yl, tl)
        stats = group.transport.stats
        out[mode] = (dict(stats.counts), dict(stats.bytes), dict(stats.dtypes))
    return out


def test_counting_transport_counts_as_a_real_two_rank_group():
    y, t = _blocks(2)
    real = mesh_lib.spawn_workers(_both_modes, 2, y, t, backend="gloo", device="cpu",
                                  threads=1, join_timeout_s=300)
    for mode in dryrun_dssfn.MODES:
        _, _, counting = dryrun_dssfn.solve_one_rank(
            mode, torch.from_numpy(y[:, :J]), torch.from_numpy(t[:, :J]), size=2, iters=K)
        s = counting.stats
        assert (dict(s.counts), dict(s.bytes), dict(s.dtypes)) == real[0][mode] == real[1][mode]
    assert real[0]["admm"][0] == {"all-reduce": K + 1}
    assert real[0]["gram"][1] == {"all-reduce": (N + Q) * N * 4}


@pytest.mark.parametrize("mode", dryrun_dssfn.MODES)
def test_one_rank_solve_is_the_simulated_solve(mode):
    """Four ranks holding the same block: the counting transport's one-rank
    solve against the simulated solve over the four (M=4 consensus ADMM,
    or the Gram-sharing solve of the four blocks side by side)."""
    # Twice as many samples as features: a well-conditioned Gram.
    y, t = (torch.from_numpy(a) for a in _blocks(1, seed=1, j=2 * N))
    z, analysis, counting = dryrun_dssfn.solve_one_rank(mode, y, t, size=4, iters=40)
    if mode == "admm":
        sim = admm.admm_ridge_consensus(y.expand(4, N, 2 * N).contiguous(),
                                        t.expand(4, Q, 2 * N).contiguous(), mu=1e-2,
                                        eps_radius=2.0 * Q, num_iters=40).o_star
    else:
        sim = readout.gram_share_solve_sharded(y.repeat(1, 4), t.repeat(1, 4),
                                               eps_radius=2.0 * Q)
    assert float((z - sim).abs().max()) <= READOUT_REL * float(sim.abs().max())
    assert analysis.collectives == counting.collectives


def test_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "dssfn")
    n, q, iters = 64, 4, 5
    j = 32
    results = dryrun_dssfn.main(["--device", "cpu", "--n", str(n), "--q", str(q),
                                 "--tokens", str(256 * j), "--iters", str(iters), "--out", out])
    admm_res, gram_res = results
    # The products' FLOPs (factors and triangular solves uncounted, as in
    # repro's hlo_analysis): the local statistics, then each iteration's
    # objective term.
    assert gram_res["flops_per_device"] == 2 * (n + q) * n * j
    assert admm_res["flops_per_device"] == 2 * (n + q) * n * j + iters * 2 * q * n * j
    assert admm_res["collective_counts"] == {"all-reduce": iters + 1}
    assert admm_res["collective_bytes"] == {"all-reduce": iters * q * n * 4 + iters * 4}
    assert gram_res["collective_counts"] == {"all-reduce": 1}
    assert gram_res["collective_bytes"] == {"all-reduce": (n + q) * n * 4}
    ring = 2 * 255 / 256
    assert gram_res["collective_wire_bytes"] == pytest.approx((n + q) * n * 4 * ring)
    for res in results:
        assert res["mesh"] == "16x16" and res["j_per_device"] == j and res["z_finite"]
        assert set(res["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}
        assert res["peak_bytes_per_device"] > (n + q) * j * 4
    printed = capsys.readouterr().out
    assert f"{iters} all-reduces of (Q, n) and one of (K,)" in printed


def test_multi_pod_splits_over_512_and_refuses_ragged_tokens():
    res = dryrun_dssfn.dryrun_solver("gram", n=32, q=2, j_total=512 * 8, iters=1,
                                     multi_pod=True, device="cpu")
    assert res["mesh"] == "2x16x16" and res["devices"] == 512 and res["j_per_device"] == 8
    with pytest.raises(ValueError, match="do not split"):
        dryrun_dssfn.dryrun_solver("gram", n=32, q=2, j_total=1000, iters=1, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        dryrun_dssfn._solver("sgd", q=2, iters=1, transport=CountingTransport(2))
