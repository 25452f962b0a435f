"""Model-zoo serving launcher: batched prefill + greedy decode loop.

    python -m repro_torch.launch.serve --arch h2o_danube3_4b --full \
        --batch 2 --prompt-len 4608 --gen-len 16

Port of ``repro/launch/serve.py`` for every config: the dense, MoE, VLM
and audio transformers, the hybrid (``--arch zamba2_2_7b``) and xLSTM
(``--arch xlstm_350m``).  Seeded random weights (``--full`` for the
published widths, else the reduced smoke config; ``--layers N`` keeps the
first N layers of either, for a model whose whole depth does not fit one
card), a seeded random prompt (an audio model's is a (B, prompt_len, nc)
codebook grid; a VLM's also has ``num_patches`` random patch embeddings
in front, standing in for the stubbed vision encoder), prefill with room
for ``prompt_len + gen_len`` positions, as the reference sizes it (xLSTM's
cache is recurrent state, so it ignores that size), then ``gen_len``
greedy decode steps.  It prints the prefill time and the decode rate.
Prefill and decode take the plain attention and the plain chunked scans
or decode recurrences, as in the reference, so no kernel launches here.
It runs on ``cuda`` unless ``--device cpu`` is given.

``--ranks W --model-parallel N`` serves any zoo model (the transformers,
the hybrid, xLSTM) sharded over a (W / N, N) grid of ranks, ``repro``'s
``make_host_mesh(model_parallel)``, as ``launch/train.py`` trains one:
each rank holds its shard of the weights (the seeded init drawn in turn,
``sharding/rules.init_shard``), prefills and decodes its data row's
prompts over its heads, channels and vocab shard, and picks each token across the
row's vocab shards (``models/steps.next_tokens``).  Rank 0 prints the
prefill time and the decode rate; the tokens are gathered over the data
rows.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, synchronize
from repro_torch.configs import ARCHS
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import _config
from repro_torch.models import build_model
from repro_torch.models.steps import make_serve_step, next_tokens


def _prompt(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The seeded prompt as host numpy, drawn as the reference draws it:
    the tokens, then a VLM's patch embeddings."""
    rng = np.random.default_rng(seed)
    audio = cfg.family == "audio"
    tok_shape = (batch, prompt_len, cfg.num_codebooks) if audio else (batch, prompt_len)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, tok_shape)}
    if cfg.family == "vlm":
        prompt["patch_embeds"] = rng.normal(size=(batch, cfg.num_patches, cfg.patch_dim))
    return prompt


def _generate(model, params, prompt: dict, *, prompt_len: int, gen_len: int, dev):
    """Prefill with room for ``prompt_len + gen_len`` positions, then
    ``gen_len`` greedy steps.  Returns (tokens (B, gen_len[, nc]) on the
    device, the prefill's last-position logits, prefill s, decode s)."""
    cfg = model.cfg
    b = prompt["tokens"].shape[0]
    step_shape = (b, 1, cfg.num_codebooks) if cfg.family == "audio" else (b, 1)
    with torch.no_grad():
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, max_len=prompt_len + gen_len)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        step_fn = make_serve_step(model)
        next_tok = next_tokens(logits[:, -1], cfg)
        generated = []
        t0 = time.perf_counter()
        for _ in range(gen_len):
            next_tok, _, cache = step_fn(params, {"tokens": next_tok.reshape(step_shape)}, cache)
            generated.append(next_tok)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    return torch.stack(generated, dim=1), logits[:, -1], t_prefill, t_decode


def _report(arch, batch, prompt_len, gen_len, t_prefill, t_decode, where) -> float:
    rate = batch * gen_len / max(t_decode, 1e-9)
    print(
        f"{arch}: prefill {prompt_len} tok in {t_prefill:.2f}s; "
        f"decoded {gen_len} tok/seq x {batch} seqs in {t_decode:.2f}s "
        f"({rate:.1f} tok/s) on {where}",
        flush=True,
    )
    return rate


def serve(
    arch: str,
    *,
    batch: int = 4,
    prompt_len: int = 64,
    gen_len: int = 32,
    reduced: bool = True,
    seed: int = 0,
    device: str | torch.device | None = None,
    params: dict | None = None,
    layers: int | None = None,
    ranks: int | None = None,
    model_parallel: int = 1,
    dist_backend: str | None = None,
) -> dict:
    """Serve one batch of ``batch`` random prompts and return
    ``{"tokens": (batch, gen_len) int64 numpy ((batch, gen_len, nc) for an
    audio model), "prefill_logits": the prompts' last-position logits
    (numpy f32), "prefill_s", "decode_s", "decode_tokens_per_s",
    "device"}``.  ``layers`` keeps the config's first ``layers`` layers.
    ``params`` replaces the seeded init (for example ``repro``'s weights,
    carried across with ``convert.transformer_params_from_numpy``,
    ``convert.hybrid_params_from_numpy`` or
    ``convert.xlstm_params_from_numpy``); the prompt is always drawn from
    ``numpy.random.default_rng(seed)`` as the reference draws it: the
    tokens, then a VLM's patch embeddings.  ``ranks`` (or a ``torchrun``
    launch) serves sharded over a grid (:func:`serve_grid`; ``params``, if
    given, is then a whole tree of host arrays, as
    ``transformer_params_from_numpy`` takes it, that each rank cuts its
    shard from)."""
    if ranks not in (None, 1) or model_parallel != 1 or mesh_lib._in_torchrun():
        return serve_grid(arch, ranks=ranks, model_parallel=model_parallel,
                          dist_backend=dist_backend, device=device, batch=batch,
                          prompt_len=prompt_len, gen_len=gen_len, reduced=reduced, seed=seed,
                          params=params, layers=layers)[0]
    dev = resolve_device(device)
    cfg = _config(arch, reduced, layers)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prompt = {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f" else None,
                                 device=dev)
              for k, v in _prompt(cfg, batch, prompt_len, seed).items()}
    toks, last, t_prefill, t_decode = _generate(model, params, prompt, prompt_len=prompt_len,
                                                gen_len=gen_len, dev=dev)
    rate = _report(arch, batch, prompt_len, gen_len, t_prefill, t_decode, dev.type)
    return {"tokens": toks.cpu().numpy(), "prefill_logits": last.float().cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode, "decode_tokens_per_s": rate,
            "device": dev.type}


def serve_rank(group, arch: str, model_parallel: int, kw: dict) -> dict:
    """One rank of :func:`serve_grid`: prefill and decode its data row's
    prompts on its shard.  Returns :func:`serve`'s keys with the tokens
    and prefill logits of the whole batch (gathered over the grid) and
    ``"grid"``."""
    from repro_torch.convert import shard_from_numpy
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules as rules_lib

    grid = mesh_lib.make_host_mesh(group, model_parallel)
    dev = grid.device
    cfg = _config(arch, kw["reduced"], kw["layers"])
    batch, seed = kw["batch"], kw["seed"]
    if batch % grid.data_parallel:
        raise ValueError(f"batch {batch} does not split over {grid.data_parallel} data rows")
    model = build_model(cfg)
    if kw["params"] is None:
        params = rules_lib.init_shard(model, grid, seed)
    else:
        params = shard_from_numpy(kw["params"], cfg, grid, device=dev)
    bl = batch // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    prompt = {k: torch.as_tensor(v[rows], dtype=torch.float32 if v.dtype.kind == "f" else None,
                                 device=dev)
              for k, v in _prompt(cfg, batch, kw["prompt_len"], seed).items()}
    with par.use_grid(grid):
        toks, last, t_prefill, t_decode = _generate(
            model, params, prompt, prompt_len=kw["prompt_len"], gen_len=kw["gen_len"], dev=dev)
        last = par.all_gather_dim(grid.model, last.float(), -2 if cfg.family == "audio" else -1)
        last = par.all_gather_dim(grid.data, last, 0)
        toks = par.all_gather_dim(grid.data, toks, 0)
    rate = batch * kw["gen_len"] / max(t_decode, 1e-9)
    if grid.rank == 0:
        _report(arch, batch, kw["prompt_len"], kw["gen_len"], t_prefill, t_decode,
                f"{dev.type}, {grid.describe()}")
    return {"tokens": toks.cpu().numpy(), "prefill_logits": last.cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode, "decode_tokens_per_s": rate,
            "device": dev.type, "grid": grid.describe()}


def serve_grid(arch: str, *, ranks: int | None = None, model_parallel: int = 1,
               dist_backend: str | None = None, device=None, **kw) -> list[dict]:
    """Serve sharded over a grid of ``ranks`` ranks, ``model_parallel`` a
    model row (:func:`serve_rank` in each); every rank's result in rank
    order (inside ``torchrun``, this rank's alone).  ``kw`` are
    :func:`serve`'s."""
    kw = {"batch": 4, "prompt_len": 64, "gen_len": 32, "reduced": True, "seed": 0,
          "params": None, "layers": None, **kw}
    if mesh_lib._in_torchrun():
        group = mesh_lib.make_worker_group(ranks=ranks, backend=dist_backend, device=device)
        return [serve_rank(group, arch, model_parallel, kw)]
    return mesh_lib.spawn_workers(serve_rank, ranks or model_parallel, arch, model_parallel,
                                  kw, backend=dist_backend, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (depth cut, widths kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be available)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the (data, model) grid (one card shows one device)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of a model row (tensor parallelism)")
    ap.add_argument("--dist-backend", choices=mesh_lib.DIST_BACKENDS, default=None,
                    help="process-group backend (default: nccl on cards, gloo on the CPU)")
    args = ap.parse_args(argv)
    res = serve(
        args.arch,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen_len=args.gen_len,
        reduced=not args.full,
        seed=args.seed,
        device=args.device,
        layers=args.layers,
        ranks=args.ranks,
        model_parallel=args.model_parallel,
        dist_backend=args.dist_backend,
    )
    print("sample tokens:", res["tokens"][0].ravel()[:16].tolist())
    return res


if __name__ == "__main__":
    main()
