"""The model zoo sharded over a (data, model) grid of gloo ranks against
``repro`` on the CPU.

- **Layout** (no ranks): every config's reduced parameters cut into each
  rank's shard by ``sharding/rules.shard_params_by_name`` on the (1, 2),
  (2, 1) and (2, 2) plans and put back together by ``unshard_params``
  give the tree back bit for bit, and a rank's shard holds
  ``launch/specs.per_device_bytes`` of it.
- **Models**, on (data=2, model=2) and (data=1, model=2), one spawn of
  gloo ranks each (a module-scoped fixture runs every case): the dense
  (with remat), MoE, VLM and audio reduced configs, ``repro``'s seeded
  weights carried across (each rank cuts its shard on the host), B=2,
  S=32 (``test_torch_train_step.py``'s batch).  The gathered logits of
  the forward are held against ``repro``'s forward at 1e-5 x max; one
  ``make_train_step`` against ``jax.value_and_grad`` of ``repro``'s loss:
  loss and grad_norm within 1e-5 relative, every gathered gradient leaf
  within 1e-4 x max|leaf|; ``launch/serve.py``'s sharded prefill and
  greedy decode give ``repro``'s ``launch/serve.py`` tokens.  The
  transports carry exactly what ``launch/dryrun.executor_collectives``
  derives from the planner for that step, and every sum crosses in f32,
  a bf16 model's too.  The vocab-parallel argmax breaks planted ties to
  the lower index.
- **CLI**: ``launch.train --ranks 4 --model-parallel 2`` gives the
  one-process run's losses within 1e-5 relative, its ``--checkpoint``
  loads as the one-process run's tree, and ``--production-mesh`` on four
  ranks raises naming the dry run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.serve import serve as j_serve
from repro.models import build_model as j_build_model
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import _tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.sharding import rules as rules_lib

FAMILIES = {
    "dense": ("h2o_danube3_4b", {"remat": True}),
    "moe": ("phi35_moe_42b", {}),
    "vlm": ("internvl2_1b", {}),
    "audio": ("musicgen_medium", {}),
}
GRIDS = {"2x2": (4, 2), "1x2": (2, 2)}
B, S = 2, 32
PROMPT, GEN = 16, 4
LOGIT_REL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 1e-4
LR = 1e-3
SUMS = ("all-reduce", "reduce-scatter")


def _plan(shape):
    return mesh_lib.MeshPlan(("data", "model"), shape)


def _coords(plan, rank):
    return dict(zip(plan.axis_names, (int(i) for i in np.unravel_index(rank, plan.shape))))


# ------------------------------------------------------------------ layout

@functools.cache
def _params(arch):
    return build_model(get_config(arch).reduced()).init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_layout_round_trip(arch, shape):
    params = _params(arch)
    plan = _plan(shape)
    rules = rules_lib.AxisRules(mesh=plan, data_axes=("data",), model_axis="model")
    specs = specs_lib.param_spec_tree(params, rules, plan)
    shards = [rules_lib.shard_params_by_name(params, rules, plan, _coords(plan, r))
              for r in range(plan.size)]
    back = rules_lib.unshard_params(shards, specs, plan)
    for (path, want), (_, got) in zip(specs_lib.leaves_with_path(params),
                                      specs_lib.leaves_with_path(back), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    want_bytes = specs_lib.per_device_bytes(params, specs, plan)
    for shard in shards:
        assert sum(t.numel() * t.element_size() for t in _tree.leaves(shard)) == want_bytes


@pytest.mark.parametrize("case", ["moe", "audio"])
def test_convert_shard_round_trip(case):
    """``convert.shard_from_numpy`` and ``opt_state_shard_from_numpy`` cut
    each rank's shard of ``repro``'s numpy params and AdamW state on the
    host; ``params_from_shards`` puts the ranks' shards back bit for
    bit."""
    import types

    from repro_torch.convert import (opt_state_shard_from_numpy, params_from_shards,
                                     shard_from_numpy)

    cfg = _config(case)
    params = {k: v for k, v in _reference(case)["params"].items()}
    rng = np.random.default_rng(1)
    state = {"step": np.int32(3),
             "m": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params),
             "v": jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), params)}
    plan = _plan((2, 2))
    rules = rules_lib.AxisRules(mesh=plan, data_axes=("data",), model_axis="model")
    grids = [types.SimpleNamespace(rules=rules, plan=plan, coords=_coords(plan, r))
             for r in range(plan.size)]
    shards = [shard_from_numpy(params, cfg, g, device="cpu") for g in grids]
    states = [opt_state_shard_from_numpy(state, cfg, g, device="cpu") for g in grids]
    for whole, parts in ((params, shards), (state["m"], [st["m"] for st in states]),
                         (state["v"], [st["v"] for st in states])):
        back = params_from_shards(parts, cfg, plan)
        for (path, want), (_, got) in zip(specs_lib.leaves_with_path(whole),
                                          specs_lib.leaves_with_path(back), strict=True):
            np.testing.assert_array_equal(got, np.asarray(want, np.float32), err_msg=str(path))
    assert all(int(st["step"]) == 3 for st in states)
    local = specs_lib.leaves_with_path(shards[3])
    assert sum(t.numel() for _, t in local) < sum(np.size(a) for _, a in
                                                  specs_lib.leaves_with_path(params)) / 2


# ------------------------------------------------------------------ models

def _config(case, **more):
    arch, over = FAMILIES[case]
    return dataclasses.replace(get_config(arch).reduced(), **over, **more)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        shape = (B, S, cfg.num_codebooks)
    else:
        shape = (B, S - cfg.num_patches if cfg.family == "vlm" else S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape),
           "labels": rng.integers(0, cfg.vocab_size, shape)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(B, cfg.num_patches, cfg.patch_dim)).astype(
            np.float32)
    return out


@functools.cache
def _reference(case):
    """repro's params (numpy), logits, loss, grad norm, gradient leaves
    and served tokens."""
    arch, over = FAMILIES[case]
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)

    @jax.jit
    def ref(params, b):
        logits, _ = jmodel.forward(params, b)
        loss, grads = jax.value_and_grad(j_make_loss_fn(jmodel))(params, b)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(grads)))
        return logits, loss, gnorm, grads

    jb = {k: jnp.asarray(a, jnp.float32 if a.dtype.kind == "f" else jnp.int32)
          for k, a in batch.items()}
    logits, loss, gnorm, grads = ref(jparams, jb)
    tokens = j_serve(arch, batch=B, prompt_len=PROMPT, gen_len=GEN)
    return {"params": jax.tree.map(np.asarray, jparams), "batch": batch,
            "logits": np.asarray(logits), "loss": float(loss), "gnorm": float(gnorm),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "tokens": np.asarray(tokens)}


class _Capture(AdamW):
    """AdamW that keeps the gradient tree it is given."""

    def update(self, params, grads, state):
        self.grads = grads
        return super().update(params, grads, state)


def _rank_case(grid, cfg, params_np, batch):
    """One config on this rank: gathered logits, loss, grad norm,
    gathered gradients, the train step's collectives."""
    from repro_torch.convert import shard_from_numpy
    from repro_torch.models.steps import make_train_step
    from repro_torch.sharding import parallel as par

    model = build_model(cfg)
    specs = rules_lib.param_specs(cfg, grid.rules, grid.plan)
    local = shard_from_numpy(params_np, cfg, grid, device="cpu")
    bl = B // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    lb = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    out = {}
    with par.use_grid(grid):
        with torch.no_grad():
            logits, _ = model.forward(local, lb)
            logits = par.all_gather_dim(grid.model, logits,
                                        -2 if cfg.family == "audio" else -1)
            out["logits"] = par.all_gather_dim(grid.data, logits, 0).float().numpy()
        opt = _Capture(lr=LR)
        step = make_train_step(model, opt)
        state = opt.init(local)
        grid.reset_stats()
        _, _, metrics = step(local, state, lb)
        out["stats"] = grid.stats()
        out["loss"], out["gnorm"] = float(metrics["loss"]), float(metrics["grad_norm"])
        out["grads"] = [g.float().numpy() for g in _tree.leaves(
            rules_lib.gather_params(opt.grads, specs, grid))]
    return out


def _threaded_backward(grid, cfg, params_np, batch) -> bool:
    """The remat'd loss's backward taken on another thread (as autograd
    runs a card tensor's backward on its device thread, which has no
    grid) equals the backward on this one."""
    import threading

    from repro_torch.convert import shard_from_numpy
    from repro_torch.models.steps import make_loss_fn
    from repro_torch.sharding import parallel as par

    model = build_model(cfg)
    local = shard_from_numpy(params_np, cfg, grid, device="cpu")
    leaves = [p.requires_grad_(True) for p in _tree.leaves(local)]
    bl = B // grid.data_parallel
    lb = {k: torch.from_numpy(v[grid.data_index * bl:(grid.data_index + 1) * bl])
          for k, v in batch.items()}
    with par.use_grid(grid):
        loss = make_loss_fn(model)(local, lb)
        here = torch.autograd.grad(loss, leaves, retain_graph=True)
    there = []
    worker = threading.Thread(target=lambda: there.extend(torch.autograd.grad(loss, leaves)))
    worker.start()
    worker.join()
    return len(there) == len(here) and all(torch.equal(a, b) for a, b in zip(here, there))


def _planted_ties(grid):
    """``next_tokens`` on logits (3, 512) with planted maxima: at 10 and
    300 (two shards), at 300 and 301 (one shard), at 400 alone."""
    from repro_torch.models.steps import next_tokens
    from repro_torch.sharding import parallel as par

    logits = torch.zeros(3, 512)
    for row, cols in enumerate(((10, 300), (300, 301), (400,))):
        logits[row, list(cols)] = 5.0
    vl = 512 // grid.model_parallel
    local = logits[:, grid.model_index * vl:(grid.model_index + 1) * vl]
    with par.use_grid(grid):
        return next_tokens(local, _config("dense")).numpy()


def _rank(group, model_parallel, refs):
    from repro_torch.launch import serve as serve_lib

    torch.set_num_threads(1)
    grid = mesh_lib.make_host_mesh(group, model_parallel)
    out = {"ties": _planted_ties(grid),
           "threaded": _threaded_backward(grid, _config("dense"), refs["dense"]["params"],
                                          refs["dense"]["batch"])}
    for case, ref in refs.items():
        out[case] = _rank_case(grid, _config(case), ref["params"], ref["batch"])
        served = serve_lib.serve_rank(
            group, FAMILIES[case][0], model_parallel,
            {"batch": B, "prompt_len": PROMPT, "gen_len": GEN, "reduced": True, "seed": 0,
             "params": ref["params"], "layers": None})
        out[case]["tokens"] = served["tokens"]
    bf16 = _config("dense", dtype="bfloat16")
    ref = refs["dense"]
    out["bf16_dtypes"] = _rank_case(grid, bf16, ref["params"], ref["batch"])["stats"]["dtypes"]
    return out if group.rank == 0 else {"ties": out["ties"], "threaded": out["threaded"]}


@pytest.fixture(scope="module")
def references():
    return {case: _reference(case) for case in FAMILIES}


@pytest.fixture(scope="module", params=list(GRIDS))
def grid_run(request, references):
    """One spawn of the grid's ranks, every case in it."""
    ranks, mp = GRIDS[request.param]
    refs = {case: {k: ref[k] for k in ("params", "batch")} for case, ref in references.items()}
    return request.param, mesh_lib.spawn_workers(_rank, ranks, mp, refs, backend="gloo",
                                                 device="cpu", threads=1, join_timeout_s=400)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_forward_logits(grid_run, references, case):
    _, out = grid_run
    got, want = out[0][case]["logits"], references[case]["logits"]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= LOGIT_REL * float(np.abs(want).max())


@pytest.mark.parametrize("case", list(FAMILIES))
def test_train_step(grid_run, references, case):
    _, out = grid_run
    got, ref = out[0][case], references[case]
    for key in ("loss", "gnorm"):
        assert abs(got[key] - ref[key]) <= LOSS_REL * abs(ref[key]), (key, got[key], ref[key])
    assert len(got["grads"]) == len(ref["grads"])
    for g, w in zip(got["grads"], ref["grads"]):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= GRAD_REL * float(np.abs(w).max())


@pytest.mark.parametrize("case", list(FAMILIES))
def test_served_tokens(grid_run, references, case):
    _, out = grid_run
    np.testing.assert_array_equal(out[0][case]["tokens"], references[case]["tokens"])


@pytest.mark.parametrize("case", list(FAMILIES))
def test_collectives_are_the_planners(grid_run, case):
    from repro_torch.launch import dryrun

    name, out = grid_run
    ranks, mp = GRIDS[name]
    stats = out[0][case]["stats"]
    want = dryrun.executor_collectives(_config(case), _plan((ranks // mp, mp)), B, S)
    got = {k: {"count": stats["counts"][k], "bytes": stats["bytes"][k]} for k in stats["counts"]}
    assert got == want
    assert {dt for (kind, dt) in stats["dtypes"] if kind in SUMS} == {"float32"}


def test_sums_cross_in_f32(grid_run):
    """A bf16 model's train step: every all-reduce and reduce-scatter
    payload is f32 (the gathers carry bf16 weights)."""
    _, out = grid_run
    assert {dt for (kind, dt) in out[0]["bf16_dtypes"] if kind in SUMS} == {"float32"}


def test_remat_recompute_runs_on_autograd_threads(grid_run):
    """The recompute of a remat'd layer runs where autograd runs the
    backward, on the card a thread of its own: it must still see the
    grid (``transformer.remat`` carries it)."""
    _, out = grid_run
    assert all(rank_out["threaded"] for rank_out in out)


def test_vocab_argmax_ties_to_the_lower_index(grid_run):
    _, out = grid_run
    for rank_out in out:
        np.testing.assert_array_equal(rank_out["ties"], [10, 300, 400])


# --------------------------------------------------------------------- CLI

def test_train_cli_sharded_matches_one_process(tmp_path):
    from repro_torch.checkpoint.store import load_pytree_flat
    from repro_torch.launch import train as train_lib

    argv = ["--arch", "h2o_danube3_4b", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "32"]
    one = train_lib.main(argv + ["--checkpoint", str(tmp_path / "one")])
    grid = train_lib.main(argv + ["--ranks", "4", "--model-parallel", "2",
                                  "--checkpoint", str(tmp_path / "grid")])
    for a, b in zip(grid, one, strict=True):
        assert abs(a - b) <= LOSS_REL * abs(b)
    want = load_pytree_flat(str(tmp_path / "one"))
    got = load_pytree_flat(str(tmp_path / "grid"))
    assert sorted(got) == sorted(want)
    lr = 3e-4
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        # Two AdamW steps move an element by about lr each.  Where the
        # gradient is well clear of eps and of its sums' rounding, the two
        # runs' updates agree to far below a thousandth of lr; a gradient
        # near 0 may take the other sign on the grid (its sums add in
        # another order), so such an element may part by up to 2 lr a step.
        # A step not applied, or applied with the wrong sign, would part
        # nearly every moved element by about lr.
        gap = (g - w).abs() - 2.0**-23 * w.abs()
        assert float(gap.max()) <= 2 * 2 * lr, path
        assert float((gap > 1e-3 * lr).float().mean()) <= 1e-3, path


def test_production_mesh_names_the_dry_run():
    from repro_torch.launch import train as train_lib

    with pytest.raises(ValueError, match="launch.dryrun"):
        train_lib.main(["--arch", "h2o_danube3_4b", "--device", "cpu", "--ranks", "4",
                        "--production-mesh"])
