"""The hybrid (Zamba2) and xLSTM families sharded over a (data, model)
grid of gloo ranks against ``repro`` and the port's one process on the
CPU, the collectives under them, and the f32 partial of a bf16
row-parallel product.

- **Models**, one spawn of 4 gloo ranks as (data=2, model=2) for every
  case: the reduced ``zamba2_2_7b`` and ``xlstm_350m`` (6 layers, d 256,
  4 heads; remat on, as ``test_torch_train_step_ssm.py`` runs them),
  ``repro``'s seeded weights carried across (each rank cuts its shard on
  the host), B=2, S=32 (``test_torch_tensor_parallel.py``'s batch).  The
  gathered logits of the forward are held against ``repro``'s forward at
  the one-card bar for these chaotic reduced models (2e-3 x max,
  ``test_torch_hybrid.py``, ``test_torch_xlstm.py``) and against the
  port's one-process forward: every layer (each Mamba2, mLSTM and sLSTM
  layer, the shared block, the head) within 1e-5 x max of the
  one-process layer on the grid's input to it
  (``models/layer_tap.py``), and the logits within 1e-5 x max or twice
  the largest move of the one-process logits under random one-ulp noise
  on the embedding outputs, whichever is larger (the layers after a
  layer amplify its rounding: that noise alone moves them by 1.0e-5 to
  2.8e-5 x max); one ``make_train_step``
  against ``jax.value_and_grad`` of ``repro``'s loss at the one-card bars
  (loss and grad_norm 1e-5 relative, every gathered gradient leaf 1e-4 x
  max, the hybrid's 5e-4); ``launch/serve.py``'s sharded prefill and
  greedy decode give ``repro``'s ``launch/serve.py`` tokens; the
  transports carry exactly what ``launch/dryrun.executor_collectives``
  derives for that step (with remat's recompute), every sum in f32.
- **Conjugate pairs**, one spawn of 2 gloo ranks as (1, 2):
  ``slice_model``, ``sum_over_model`` and ``gather_model(scatter=True)``
  give the values and gradients of the one-rank function they split.
- **bf16 row-parallel products**, on the same (1, 2) grid: a bf16
  SwiGLU and a bf16 attention block are within one bf16 ulp of the same
  block in one process, element by element.
- **CLI**: ``launch.train --arch zamba2_2_7b|xlstm_350m --ranks 4
  --model-parallel 2`` gives the one-process run's losses within 1e-5
  relative.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.sharding import rules as rules_lib

FAMILIES = {"hybrid": "zamba2_2_7b", "xlstm": "xlstm_350m"}
B, S = 2, 32
PROMPT, GEN = 16, 4
REPRO_LOGIT_REL, ONE_LOGIT_REL = 2e-3, 1e-5
# These reduced models amplify rounding: each embedding output moved one
# f32 ulp up or down at random (a quarter of them each way) moves the
# one-process logits by 1.01e-5 to 1.10e-5 (hybrid) and 1.56e-5 to
# 2.83e-5 (xLSTM) x max over three seeds, so the grid's logits are held
# to the larger of 1e-5 x max and this many times the largest of those
# moves; each layer, before the amplification, to 1e-5 x max.
NOISE_RESPONSES, NOISE_SEEDS = 2, 3
LOSS_REL = 1e-5
GRAD_REL = {"hybrid": 5e-4, "xlstm": 1e-4}
LR = 1e-3
SUMS = ("all-reduce", "reduce-scatter")


def _plan(shape):
    return mesh_lib.MeshPlan(("data", "model"), shape)


def _config(case, **more):
    return dataclasses.replace(get_config(FAMILIES[case]).reduced(), remat=True, **more)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


@functools.cache
def _reference(case):
    """repro's params (numpy), logits, loss, grad norm, gradient leaves
    and served tokens.  (jax and repro are imported here, not with the
    module: every spawned rank imports this module.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.launch.serve import serve as j_serve
    from repro.models import build_model as j_build_model
    from repro.models.steps import make_loss_fn as j_make_loss_fn

    arch = FAMILIES[case]
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), remat=True)
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

    logits, loss, gnorm, grads = ref(jparams, {k: jnp.asarray(a, jnp.int32)
                                               for k, a in batch.items()})
    tokens = j_serve(arch, batch=B, prompt_len=PROMPT, gen_len=GEN)
    return {"params": jax.tree.map(np.asarray, jparams), "batch": batch,
            "logits": np.asarray(logits), "loss": float(loss), "gnorm": float(gnorm),
            "grads": [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)],
            "tokens": np.asarray(tokens)}


def _noisy(embed, seed):
    """``embed`` with each output moved one ulp up or down at random, a
    quarter of them each way (rounding noise of half an ulp on average)."""
    def call(*args):
        e = embed(*args)
        r = torch.randint(0, 4, e.shape, generator=torch.Generator().manual_seed(seed))
        up = torch.nextafter(e, torch.full_like(e, float("inf")))
        down = torch.nextafter(e, torch.full_like(e, -float("inf")))
        return torch.where(r == 0, up, torch.where(r == 1, down, e))

    return call


@functools.cache
def _one_process(case):
    """The port's model, params and batch in one process on repro's
    weights, its forward logits, and the largest move of those logits
    under :func:`_noisy` embedding outputs over ``NOISE_SEEDS`` seeds."""
    from repro_torch.convert import hybrid_params_from_numpy, xlstm_params_from_numpy
    from repro_torch.models import hybrid_model, xlstm_model

    cfg = _config(case)
    ref = _reference(case)
    convert = hybrid_params_from_numpy if case == "hybrid" else xlstm_params_from_numpy
    module = hybrid_model if case == "hybrid" else xlstm_model
    params = convert(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    model = build_model(cfg)
    response = 0.0
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        for seed in range(NOISE_SEEDS):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "embed_tokens", _noisy(module.embed_tokens, seed))
                moved, _ = model.forward(params, batch)
            response = max(response, float((moved - logits).abs().max()))
    return model, params, batch, logits.numpy(), response


class _Capture(AdamW):
    """AdamW that keeps the gradient tree it is given."""

    def update(self, params, grads, state):
        self.grads = grads
        return super().update(params, grads, state)


def _rank_case(grid, cfg, params_np, batch):
    """One config on this rank: gathered logits, the forward's layer
    taps, loss, grad norm, gathered gradients, the train step's
    collectives."""
    from repro_torch.convert import shard_from_numpy
    from repro_torch.models.layer_tap import LayerTap
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
        with torch.no_grad(), LayerTap() as tap:
            logits, _ = model.forward(local, lb)
        out["calls"] = [(name, x.numpy(), y.numpy()) for name, x, y in tap.calls]
        with torch.no_grad():
            logits = par.all_gather_dim(grid.model, logits, -1)
            out["logits"] = par.all_gather_dim(grid.data, logits, 0).numpy()
        opt = _Capture(lr=LR)
        step = make_train_step(model, opt)
        grid.reset_stats()
        _, _, metrics = step(local, opt.init(local), lb)
        out["stats"] = grid.stats()
        out["loss"], out["gnorm"] = float(metrics["loss"]), float(metrics["grad_norm"])
        out["grads"] = [g.float().numpy() for g in _tree.leaves(
            rules_lib.gather_params(opt.grads, specs, grid))]
    return out


def _rank(group, refs):
    from repro_torch.launch import serve as serve_lib

    torch.set_num_threads(1)
    grid = mesh_lib.make_host_mesh(group, 2)
    out = {}
    for case, ref in refs.items():
        out[case] = _rank_case(grid, _config(case), ref["params"], ref["batch"])
        served = serve_lib.serve_rank(
            group, FAMILIES[case], 2,
            {"batch": B, "prompt_len": PROMPT, "gen_len": GEN, "reduced": True, "seed": 0,
             "params": ref["params"], "layers": None})
        out[case]["tokens"] = served["tokens"]
    out["coords"] = grid.coords
    return out


@pytest.fixture(scope="module")
def references():
    return {case: _reference(case) for case in FAMILIES}


@pytest.fixture(scope="module")
def grid_run(references):
    """One spawn of the 2x2 grid's ranks, every case in it."""
    from repro_torch.models.layer_tap import gather_calls

    refs = {case: {k: ref[k] for k in ("params", "batch")} for case, ref in references.items()}
    ranks = mesh_lib.spawn_workers(_rank, 4, refs, backend="gloo", device="cpu", threads=1,
                                   join_timeout_s=400)
    out = ranks[0]
    for case in FAMILIES:
        out[case]["calls"] = gather_calls(
            [(r["coords"], [(n, torch.from_numpy(x), torch.from_numpy(y))
                            for n, x, y in r[case]["calls"]]) for r in ranks])
    return out


@pytest.mark.parametrize("case", list(FAMILIES))
def test_forward_logits(grid_run, references, case):
    got, want = grid_run[case]["logits"], references[case]["logits"]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= REPRO_LOGIT_REL * float(np.abs(want).max())
    one, response = _one_process(case)[3:]
    bar = max(ONE_LOGIT_REL * float(np.abs(one).max()), NOISE_RESPONSES * response)
    assert float(np.abs(got - one).max()) <= bar, (float(np.abs(got - one).max()), bar)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_layers_against_one_process(grid_run, case):
    """Each layer of the grid's forward against the one-process layer on
    the grid's input to it, and every rank of a model row holding the same
    activations."""
    from repro_torch.models.layer_tap import LayerTap

    calls, rows_agree = grid_run[case]["calls"]
    assert rows_agree
    model, params, batch = _one_process(case)[:3]
    with torch.no_grad(), LayerTap(replay=calls) as one:
        model.forward(params, batch)
    names = [c[0] for c in calls]
    assert names == [c[0] for c in one.calls]
    assert names.count("head_logits") == 1 and len(names) > 6
    for i, ((name, _, got), (_, _, want)) in enumerate(zip(calls, one.calls)):
        gap = float((got.float() - want.float()).abs().max())
        assert gap <= ONE_LOGIT_REL * float(want.abs().max()), (i, name, gap)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_train_step(grid_run, references, case):
    got, ref = grid_run[case], references[case]
    for key in ("loss", "gnorm"):
        assert abs(got[key] - ref[key]) <= LOSS_REL * abs(ref[key]), (key, got[key], ref[key])
    assert len(got["grads"]) == len(ref["grads"])
    for g, w in zip(got["grads"], ref["grads"]):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= GRAD_REL[case] * float(np.abs(w).max())


@pytest.mark.parametrize("case", list(FAMILIES))
def test_served_tokens(grid_run, references, case):
    np.testing.assert_array_equal(grid_run[case]["tokens"], references[case]["tokens"])


@pytest.mark.parametrize("case", list(FAMILIES))
def test_collectives_are_the_planners(grid_run, case):
    from repro_torch.launch import dryrun

    stats = grid_run[case]["stats"]
    want = dryrun.executor_collectives(_config(case), _plan((2, 2)), B, S)
    got = {k: {"count": stats["counts"][k], "bytes": stats["bytes"][k]} for k in stats["counts"]}
    assert got == want
    assert {dt for (kind, dt) in stats["dtypes"] if kind in SUMS} == {"float32"}


@pytest.mark.parametrize("case", list(FAMILIES))
def test_convert_shard_round_trip(case):
    """``convert.shard_from_numpy`` cuts each rank's shard of ``repro``'s
    numpy params of either family on the host, by the planner's spec tree
    (a bf16 model's f32 leaves kept in f32), and ``params_from_shards``
    puts the ranks' shards back bit for bit."""
    import types

    from repro_torch.convert import params_from_shards, shard_from_numpy
    from repro_torch.launch import specs as specs_lib

    cfg = _config(case, dtype="bfloat16")
    params = _reference(case)["params"]
    plan = _plan((2, 2))
    rules = rules_lib.AxisRules(mesh=plan, data_axes=("data",), model_axis="model")
    grids = [types.SimpleNamespace(rules=rules, plan=plan, coords=dict(
        zip(plan.axis_names, (int(i) for i in np.unravel_index(r, plan.shape)))))
        for r in range(plan.size)]
    shards = [shard_from_numpy(params, cfg, g, device="cpu") for g in grids]
    f32 = {("mamba", "a_log"), ("mamba", "dt_bias"), ("mlstm", "wi"), ("mlstm", "wf"),
           ("slstm", "rw")}
    for path, leaf in specs_lib.leaves_with_path(shards[3]):
        assert leaf.dtype == (torch.float32 if path in f32 else torch.bfloat16), path
    back = params_from_shards(shards, cfg, plan)
    for (path, want), (_, got) in zip(specs_lib.leaves_with_path(params),
                                      specs_lib.leaves_with_path(back), strict=True):
        want = np.array(want, np.float32)
        if path not in f32:
            want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(path))


# ------------------------------------------------------ the (1, 2) grid

def _ulps_bf16(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of want's bf16 ulp, element by
    element (2**(e - 7) for |want| in [2**e, 2**(e+1)))."""
    w = want.float()
    e = torch.floor(torch.log2(w.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)))
    return float(((got.float() - w).abs() / torch.exp2(e - 7)).max())


def _block(t: torch.Tensor, dim: int, r: int, n: int = 2) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


def _bf16_blocks(grid) -> dict:
    """A bf16 SwiGLU and a bf16 attention block: this rank's sharded
    output and the one-process output, on the same seeded inputs."""
    from repro_torch.models import blocks
    from repro_torch.nn.mlp import swiglu
    from repro_torch.sharding import parallel as par

    r = grid.model_index
    gen = torch.Generator().manual_seed(3)
    d, f = 256, 512
    x = torch.randn((2, 32, d), generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn((d, f), generator=gen).div(16).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn((f, d), generator=gen).div(22).to(torch.bfloat16)
    out = {"swiglu": (swiglu(x, wg, wu, wd),)}
    with par.use_grid(grid):
        out["swiglu"] += (swiglu(x, _block(wg, 1, r), _block(wu, 1, r), _block(wd, 0, r),
                                 model_split=True),)
    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), dtype="bfloat16")
    attn = build_model(cfg).init(gen)["layers"]["attn"]
    attn = {k: v[0] for k, v in attn.items()}
    local = {k: _block(v, 0 if k == "wo" else 1, r) for k, v in attn.items()}
    pos = torch.arange(32)
    out["attention"] = (blocks.apply_attention(attn, x, pos, cfg, None, window=None)[0],)
    with par.use_grid(grid):
        out["attention"] += (blocks.apply_attention(local, x, pos, cfg, None, window=None)[0],)
    return {k: _ulps_bf16(got, want) for k, (want, got) in out.items()}


def _pair_grads(grid) -> dict:
    """Each new conjugate pair's value and gradient on this rank, and the
    one-rank function's, on the same seeded inputs: the largest gap."""
    from repro_torch.sharding import parallel as par

    r = grid.model_index
    gen = torch.Generator().manual_seed(5)
    x, c = torch.randn((6, 4), generator=gen), torch.randn((2, 6, 4), generator=gen)
    xs = torch.randn((2, 6, 2), generator=gen)
    gaps = {}

    # slice_model: rank r reads its block of a whole x; the row's loss is
    # sum(x * c[0]) (each rank scores its block), the gradient c[0] whole.
    xr = x.clone().requires_grad_(True)
    with par.use_grid(grid):
        y = par.slice_model(xr, -1)
    (y * _block(c[0], 1, r)).sum().backward()
    gaps["slice_model"] = max(float((y - _block(x, 1, r)).abs().max()),
                              float((xr.grad - c[0]).abs().max()))

    # sum_over_model: rank r holds xs[r]; each reads the sum and scores it
    # with c[r][:, :2]; the one-rank loss is sum((xs[0] + xs[1]) * (c0 + c1)).
    ws = c[:, :, :2]
    one = xs.clone().requires_grad_(True)
    ((one[0] + one[1]) * (ws[0] + ws[1])).sum().backward()
    mine = xs[r].clone().requires_grad_(True)
    with par.use_grid(grid):
        y = par.sum_over_model(mine)
    (y * ws[r]).sum().backward()
    gaps["sum_over_model"] = max(float((y - (xs[0] + xs[1])).abs().max()),
                                 float((mine.grad - one.grad[r]).abs().max()))

    # gather_model(scatter=True): rank r holds xs[r] (a block of columns);
    # each reads the whole and scores it with c[r]; the one-rank loss is
    # sum(cat(xs) * (c0 + c1)).
    one = xs.clone().requires_grad_(True)
    (torch.cat(one.unbind(0), -1) * (c[0] + c[1])).sum().backward()
    mine = xs[r].clone().requires_grad_(True)
    with par.use_grid(grid):
        y = par.gather_model(mine, -1, scatter=True)
    (y * c[r]).sum().backward()
    gaps["gather_model"] = max(float((y - torch.cat(xs.unbind(0), -1)).abs().max()),
                               float((mine.grad - one.grad[r]).abs().max()))
    return gaps


def _pair_rank(group):
    torch.set_num_threads(1)
    grid = mesh_lib.make_host_mesh(group, 2)
    return {"bf16": _bf16_blocks(grid), "pairs": _pair_grads(grid)}


@pytest.fixture(scope="module")
def pair_run():
    return mesh_lib.spawn_workers(_pair_rank, 2, backend="gloo", device="cpu", threads=1,
                                  join_timeout_s=300)


@pytest.mark.parametrize("fn", ["slice_model", "sum_over_model", "gather_model"])
def test_conjugate_pair_gradients(pair_run, fn):
    for rank_out in pair_run:
        assert rank_out["pairs"][fn] <= 1e-6, (fn, rank_out["pairs"][fn])


@pytest.mark.parametrize("block", ["swiglu", "attention"])
def test_bf16_row_parallel_within_one_ulp(pair_run, block):
    """Each rank keeps its partial product in f32 through the f32 sum over
    the row and rounds once, as the one-process product rounds its f32
    sum once: at most one bf16 ulp apart.  Rounding each partial to bf16
    before the sum, as the grid did before, put the SwiGLU 1813 ulps and
    the attention block 776 ulps apart on these inputs (outputs near 0,
    whose ulp is far below the partials')."""
    for rank_out in pair_run:
        assert rank_out["bf16"][block] <= 1.0, (block, rank_out["bf16"][block])


# --------------------------------------------------------------------- CLI

@pytest.mark.parametrize("case", list(FAMILIES))
def test_train_cli_sharded_matches_one_process(case):
    """The command that crashed each rank in ``rules.init_shard`` before
    these families ran on a grid."""
    from repro_torch.launch import train as train_lib

    argv = ["--arch", FAMILIES[case], "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "32"]
    one = train_lib.main(argv)
    grid = train_lib.main(argv + ["--ranks", "4", "--model-parallel", "2"])
    for a, b in zip(grid, one, strict=True):
        assert abs(a - b) <= LOSS_REL * abs(b)
