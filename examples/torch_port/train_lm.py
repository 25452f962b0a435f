"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with the AD training path (the gradient-descent baseline the paper
compares against), in one process.

    PYTHONPATH=src python examples/torch_port/train_lm.py [--steps 200] [--device cpu]

The PyTorch twin of ``examples/train_lm.py``.  ``repro``'s one-device host
mesh is the port's one-process path (``launch/train.py`` without
``--ranks``).  The threefry key draws ``repro``'s weights (to a few f32
ulps), so the losses are ``repro``'s; :func:`run` takes any weights, such
as ``repro``'s own carried across with
``repro_torch.convert.transformer_params_from_numpy``.  Training takes
the plain path: no kernel op has a backward.
"""
import argparse

import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.data import TokenStream
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW

# ~100M params: 8 layers, d=768, vocab 32k (danube-style dense blocks).
CFG = ModelConfig(
    name="lm-100m", family="dense", num_layers=8, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
    dtype="float32", attn_chunk=128, remat=False,
    source="examples/train_lm.py",
)


def run(args, device, params=None) -> dict:
    """``args.steps`` AdamW steps of ``args.batch`` x ``args.seq`` tokens
    from ``params`` (by default the seeded init); prints the losses and
    returns them."""
    cfg = CFG
    model = build_model(cfg)
    n_params = cfg.param_count()
    print(f"model: {n_params/1e6:.0f}M params")

    opt = AdamW(lr=3e-4)
    stream = iter(TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              batch_size=args.batch, seed=0))

    if params is None:
        params = model.init(key=prng.PRNGKey(0), device=device)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    first = None
    losses = []
    for i in range(args.steps):
        b = next(stream)
        batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        first = first if first is not None else loss
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:.4f}", flush=True)
    print(f"loss {first:.3f} -> {loss:.3f} "
          f"({'improved' if loss < first - 0.5 else 'check hyperparams'})")
    return {"params": n_params, "losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
