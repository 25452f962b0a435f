"""Model-zoo training launcher: AdamW on a synthetic token stream.

    python -m repro_torch.launch.train --arch h2o_danube3_4b --steps 3 --device cpu
    python -m repro_torch.launch.train --arch h2o_danube3_4b --full \
        --batch 1 --seq 4096 --steps 6
    python -m repro_torch.launch.train --arch h2o_danube3_4b --steps 3 --device cpu \
        --ranks 4 --model-parallel 2

Port of ``repro/launch/train.py`` for every config: seeded random weights
(``--full`` for the published widths, else the reduced smoke config;
``--layers N`` keeps the first N layers of either, for a model whose
weights, gradients and moments do not fit one card whole), the reference's
``TokenStream`` (seed 0, a planted bigram table; ``seq - num_patches``
tokens for a VLM, whose ``num_patches`` patch embeddings, standing in for
the stubbed vision encoder, are drawn each step from
``numpy.random.default_rng(0)``), ``make_train_step`` with
``AdamW(lr)``, and the final params written with
``checkpoint.save_pytree`` when ``--checkpoint`` is given.  Training takes
the plain path (no kernel op has a backward) with the config's remat.  It
runs on ``cuda`` unless ``--device cpu`` is given.

``--ranks W --model-parallel N`` trains any zoo model (the transformers,
the hybrid, xLSTM) sharded over a (W / N, N) grid of ranks, ``repro``'s
``make_host_mesh(model_parallel)`` (one card shows one device, so the
rank count is given, as ``train_dssfn --ranks`` takes it): W processes
(``launch/mesh.spawn_workers``; inside ``torchrun`` its ranks), each
holding its shard of the weights and moments (the ranks draw the seeded
init in turn, ``sharding/rules.init_shard``) and its data row's B / (W / N)
sequences of every batch.  ``--dist-backend`` names the process groups'
backend (``gloo`` for ranks sharing a card, ``nccl`` with a card each).
The losses are the one-rank run's; ``--checkpoint`` gathers the shards and
rank 0 writes ``repro``'s schema.  ``--production-mesh`` trains on the
(16, 16) plan's grid, which needs a world of 256 ranks (``torchrun``);
``python -m repro_torch.launch.dryrun`` plans that mesh on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW


def _config(arch: str, reduced: bool, layers: int | None):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def _stream(cfg, batch: int, seq: int) -> TokenStream:
    return TokenStream(
        vocab_size=cfg.vocab_size,
        seq_len=seq - (cfg.num_patches if cfg.family == "vlm" else 0),
        batch_size=batch,
        num_codebooks=cfg.num_codebooks,
    )


def _loop(cfg, step_fn, params, opt_state, *, steps, batch, seq, dev, log_every,
          rows=slice(None), verbose=True, on_step=None):
    """``steps`` train steps on the stream's batches (their ``rows``);
    returns (params, losses)."""
    vlm = cfg.family == "vlm"
    losses = []
    it = iter(_stream(cfg, batch, seq))
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for i in range(steps):
        b = {k: torch.as_tensor(v[rows], device=dev) for k, v in next(it).items()}
        if vlm:
            patches = rng.normal(size=(batch, cfg.num_patches, cfg.patch_dim))[rows]
            b["patch_embeds"] = torch.as_tensor(patches, dtype=torch.float32, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i, metrics)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(
                f"step {i:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.perf_counter() - t0:.1f}s)",
                flush=True,
            )
    return params, losses


def train(
    arch: str,
    *,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    reduced: bool = True,
    lr: float = 3e-4,
    log_every: int = 5,
    checkpoint_path: str | None = None,
    device: str | torch.device | None = None,
    params: dict | None = None,
    layers: int | None = None,
    ranks: int | None = None,
    model_parallel: int = 1,
    dist_backend: str | None = None,
    production_mesh: bool = False,
) -> list[float]:
    """Train ``steps`` steps and return the loss of each, as floats.
    ``layers`` keeps the config's first ``layers`` layers.  ``params``
    replaces the seeded init (for example ``repro``'s weights carried
    across with ``convert.transformer_params_from_numpy``) and is updated
    in place, as the optimizer updates every step's params.  ``ranks``
    (or a ``torchrun`` launch, or ``production_mesh``) trains sharded
    over a grid (:func:`train_grid`; ``params``, if given, is then a whole
    tree of host arrays, as ``transformer_params_from_numpy`` takes it,
    that each rank cuts its shard from)."""
    if ranks not in (None, 1) or model_parallel != 1 or production_mesh or mesh_lib._in_torchrun():
        reports = train_grid(
            arch, ranks=ranks, model_parallel=model_parallel, dist_backend=dist_backend,
            production_mesh=production_mesh, steps=steps, batch=batch, seq=seq,
            reduced=reduced, lr=lr, log_every=log_every, checkpoint_path=checkpoint_path,
            device=device, params=params, layers=layers)
        return reports[0]["losses"]
    dev = resolve_device(device)
    cfg = _config(arch, reduced, layers)
    model = build_model(cfg)
    opt = AdamW(lr=lr)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    params, losses = _loop(cfg, step_fn, params, opt_state, steps=steps, batch=batch,
                           seq=seq, dev=dev, log_every=log_every)
    if checkpoint_path:
        from repro_torch.checkpoint import save_pytree

        save_pytree(checkpoint_path, params)
        print(f"saved checkpoint to {checkpoint_path}")
    return losses


def production_plan(world: int) -> mesh_lib.MeshPlan:
    """The (16, 16) production plan, for a world of its 256 ranks."""
    plan = mesh_lib.make_production_mesh()
    if world != plan.size:
        raise ValueError(
            f"--production-mesh runs the {plan.name} plan's {plan.size} ranks (torchrun), "
            f"not {world}; plan that mesh on one card with "
            "`python -m repro_torch.launch.dryrun`")
    return plan


def train_rank(group, arch: str, model_parallel: int, production_mesh: bool, kw: dict) -> dict:
    """One rank of :func:`train_grid`: this rank's shard trained on its
    data row.  Returns ``{"losses", "grad_norms", "step_ms", "tokens_per_s",
    "peak_bytes", "step_stats", "grid"}``; ``step_stats`` holds what the
    grid's transports carried in each step (by kind: counts, bytes, payload
    dtypes)."""
    from repro_torch._device import synchronize
    from repro_torch.convert import shard_from_numpy
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules as rules_lib

    plan = production_plan(group.size) if production_mesh else None
    grid = mesh_lib.make_host_mesh(group, model_parallel, plan=plan)
    dev = grid.device
    cfg = _config(arch, kw["reduced"], kw["layers"])
    batch, seq = kw["batch"], kw["seq"]
    if batch % grid.data_parallel:
        raise ValueError(f"batch {batch} does not split over {grid.data_parallel} data rows")
    model = build_model(cfg)
    opt = AdamW(lr=kw["lr"])
    specs = rules_lib.param_specs(cfg, grid.rules, grid.plan)
    if kw["params"] is None:
        params = rules_lib.init_shard(model, grid)
    else:
        params = shard_from_numpy(kw["params"], cfg, grid, device=dev)
    opt_state = opt.init(params)
    bl = batch // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    step_ms, step_stats, norms = [], [], []
    real_step = make_train_step(model, opt)
    lead = grid.rank == 0

    def step_fn(*args):
        grid.reset_stats()
        synchronize(dev)
        t0 = time.perf_counter()
        out = real_step(*args)
        synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_stats.append(grid.stats())
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with par.use_grid(grid):
        params, losses = _loop(cfg, step_fn, params, opt_state, steps=kw["steps"],
                               batch=batch, seq=seq, dev=dev, log_every=kw["log_every"],
                               rows=rows, verbose=lead,
                               on_step=lambda i, m: norms.append(float(m["grad_norm"])))
    if kw["checkpoint_path"]:
        whole = rules_lib.gather_params(params, specs, grid)
        if lead:
            from repro_torch.checkpoint import save_pytree

            save_pytree(kw["checkpoint_path"], whole)
            print(f"saved checkpoint to {kw['checkpoint_path']}", flush=True)
        del whole
        grid.world.barrier()
    tokens = batch * seq
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "tokens_per_s": [tokens / (t / 1e3) for t in step_ms],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            "step_stats": step_stats, "grid": grid.describe(), "rank": grid.rank}


def train_grid(
    arch: str,
    *,
    ranks: int | None = None,
    model_parallel: int = 1,
    dist_backend: str | None = None,
    production_mesh: bool = False,
    device: str | torch.device | None = None,
    **kw,
) -> list[dict]:
    """Train sharded over a grid of ``ranks`` ranks, ``model_parallel`` a
    model row (:func:`train_rank` in each), and return every rank's
    report in rank order.  Inside a ``torchrun`` launch this process is
    one rank and the list holds its report alone.  ``kw`` are
    :func:`train`'s."""
    kw = {"steps": 20, "batch": 8, "seq": 128, "reduced": True, "lr": 3e-4, "log_every": 5,
          "checkpoint_path": None, "params": None, "layers": None, **kw}
    if mesh_lib._in_torchrun():
        group = mesh_lib.make_worker_group(ranks=ranks, backend=dist_backend, device=device)
        return [train_rank(group, arch, model_parallel, production_mesh, kw)]
    if ranks is None:
        ranks = model_parallel
    if production_mesh:
        production_plan(ranks)
    return mesh_lib.spawn_workers(train_rank, ranks, arch, model_parallel, production_mesh, kw,
                                  backend=dist_backend, device=device)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (depth cut, widths kept)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be available)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the (data, model) grid (one card shows one device)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of a model row (tensor parallelism)")
    ap.add_argument("--dist-backend", choices=mesh_lib.DIST_BACKENDS, default=None,
                    help="process-group backend (default: nccl on cards, gloo on the CPU)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) plan's grid (a torchrun world of 256 ranks)")
    args = ap.parse_args(argv)
    losses = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        reduced=not args.full,
        lr=args.lr,
        checkpoint_path=args.checkpoint,
        device=args.device,
        layers=args.layers,
        ranks=args.ranks,
        model_parallel=args.model_parallel,
        dist_backend=args.dist_backend,
        production_mesh=args.production_mesh,
    )
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
