"""The MoE's tensor-parallel path on a (data=2, model=2) grid of gloo ranks
against ``repro``'s ``_moe_core`` on the CPU.

``repro``'s own case (``tests/test_multidevice.py``: b, s, d, f, e, k =
4, 32, 16, 32, 4, 2, capacity factor e) on the same numpy inputs: the
port's ``moe_ffn_parallel`` on each rank's shard of the weights (cut by
``sharding/rules.shard_params_by_name``, FSDP on and off) and its data
row's two sequences, held against ``_moe_core`` on the whole batch for
the output, the aux loss and the gradient of sum(out**2) w.r.t. ``wg``,
at ``repro``'s bars (1e-4 absolute, 1e-4 absolute, 1e-3 relative to
max|grad|).  With f = 31, which does not split over the model row, or d
= 15, which does not split over the data rows, the plain path is taken
and matches too.  One
spawn of four ranks runs every case.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.moe import _moe_core
from repro_torch.launch import mesh as mesh_lib

B, S, E, K = 4, 32, 4, 2
#: (d, f, FSDP)
CASES = {"fsdp": (16, 32, True), "no_fsdp": (16, 32, False),
         "odd_f": (16, 31, True), "odd_d": (15, 32, True)}
OUT_TOL, AUX_TOL, GRAD_REL = 1e-4, 1e-4, 1e-3


def _inputs(d: int, f: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(B, S, d)).astype(np.float32),
        "router": rng.normal(size=(d, E)).astype(np.float32),
        "wg": (rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32),
        "wu": (rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32),
        "wd": (rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32),
    }


def _rank(group, cases):
    """Every case on this rank: (out, aux, the gathered d sum(out^2) / d wg,
    the forward's collectives over the model row by kind)."""
    import dataclasses

    from repro_torch.nn.moe import moe_ffn_parallel
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules as rules_lib

    torch.set_num_threads(1)
    base = mesh_lib.make_host_mesh(group, 2)
    out = {}
    for name, (d, f, fsdp, arrays) in cases.items():
        grid = dataclasses.replace(base, fsdp=fsdp)
        weights = {"router": arrays["router"],
                   "ffn": {k: arrays[k] for k in ("wg", "wu", "wd")}}
        local = rules_lib.shard_params_by_name(weights, grid.rules, grid.plan, grid.coords)
        local = {"router": torch.from_numpy(local["router"]),
                 **{k: torch.from_numpy(v).requires_grad_(k == "wg")
                    for k, v in local["ffn"].items()}}
        rows = slice(grid.data_index * (B // 2), (grid.data_index + 1) * (B // 2))
        x = torch.from_numpy(arrays["x"][rows])
        grid.reset_stats()
        with par.use_grid(grid):
            y, stats = moe_ffn_parallel(x, local["router"], local["wg"], local["wu"],
                                        local["wd"], top_k=K, capacity_factor=float(E), d_ff=f)
            forward = dict(grid.model.stats.counts)
            (g,) = torch.autograd.grad(torch.sum(y ** 2), local["wg"])
            scattered = dict(grid.data.stats.counts)
            f_split = g.shape[1] != d
            if not f_split:   # a replicated leaf's gradient: summed over the data rows
                g = par.sum_f32(grid.data, g)
            g = par.all_gather_dim(grid.model, g, -1) if g.shape[-1] != f else g
            g = par.all_gather_dim(grid.data, g, 1) if f_split else g
            y = par.all_gather_dim(grid.data, y.detach(), 0)
        out[name] = (y.numpy(), float(stats.aux_loss), g.numpy(), forward, scattered)
    return out


@pytest.fixture(scope="module")
def results():
    cases = {name: (d, f, fsdp, _inputs(d, f)) for name, (d, f, fsdp) in CASES.items()}
    got = mesh_lib.spawn_workers(_rank, 4, cases, backend="gloo", device="cpu", threads=1,
                                 join_timeout_s=300)
    return cases, got


@functools.cache
def _reference(d: int, f: int):
    a = {k: jnp.asarray(v) for k, v in _inputs(d, f).items()}
    import jax

    def core(wg):
        return _moe_core(a["x"], a["router"], wg, a["wu"], a["wd"], top_k=K,
                         capacity_factor=float(E), constrain=False)

    out, stats = core(a["wg"])
    grad = jax.grad(lambda w: jnp.sum(core(w)[0] ** 2))(a["wg"])
    return np.asarray(out), float(stats.aux_loss), np.asarray(grad)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rank", range(4))
def test_moe_parallel_matches_repro(results, case, rank):
    cases, got = results
    out, aux, grad = got[rank][case][:3]
    want_out, want_aux, want_grad = _reference(*cases[case][:2])
    assert float(np.abs(out - want_out).max()) < OUT_TOL
    assert abs(aux - want_aux) < AUX_TOL
    gerr = float(np.abs(grad - want_grad).max() / (np.abs(want_grad).max() + 1e-9))
    assert gerr < GRAD_REL, gerr


@pytest.mark.parametrize("case", list(CASES))
def test_moe_parallel_path(results, case):
    """f = 32 splits over the model row: the tensor-parallel path, whose
    forward adds the combined (B/2, S, d) output over the row, once.
    f = 31 does not: the plain path on whole experts, nothing over the
    row.  d = 15 does not split over the data rows, so with FSDP on
    ``repro`` takes the plain path too: the row gathers its experts'
    f-slices whole."""
    _, got = results
    forward, backward = got[0][case][3:]
    want = {"odd_f": {}, "odd_d": {"all-gather": 3}}.get(case, {"all-reduce": 1})
    assert forward == want
    split = CASES[case][2] and CASES[case][0] % 2 == 0
    assert backward.get("reduce-scatter", 0) == (1 if split else 0)    # wg's gradient alone
