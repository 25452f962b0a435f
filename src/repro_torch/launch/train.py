"""Model-zoo training launcher: AdamW on a synthetic token stream.

    python -m repro_torch.launch.train --arch h2o_danube3_4b --steps 3 --device cpu
    python -m repro_torch.launch.train --arch h2o_danube3_4b --full \
        --batch 1 --seq 4096 --steps 6

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
runs on ``cuda`` unless ``--device cpu`` is given; there is one card, so
the reference's ``--model-parallel`` and ``--production-mesh`` are left
out.
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
from repro_torch.models import build_model
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW


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
) -> list[float]:
    """Train ``steps`` steps and return the loss of each, as floats.
    ``layers`` keeps the config's first ``layers`` layers.  ``params``
    replaces the seeded init (for example ``repro``'s weights carried
    across with ``convert.transformer_params_from_numpy``) and is updated
    in place, as the optimizer updates every step's params."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    opt = AdamW(lr=lr)
    vlm = cfg.family == "vlm"
    stream = TokenStream(
        vocab_size=cfg.vocab_size,
        seq_len=seq - (cfg.num_patches if vlm else 0),
        batch_size=batch,
        num_codebooks=cfg.num_codebooks,
    )
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    losses = []
    it = iter(stream)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
        if vlm:
            patches = rng.normal(size=(batch, cfg.num_patches, cfg.patch_dim))
            b["patch_embeds"] = torch.as_tensor(patches, dtype=torch.float32, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(
                f"step {i:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.perf_counter() - t0:.1f}s)",
                flush=True,
            )
    if checkpoint_path:
        from repro_torch.checkpoint import save_pytree

        save_pytree(checkpoint_path, params)
        print(f"saved checkpoint to {checkpoint_path}")
    return losses


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
    )
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
