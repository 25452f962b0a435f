"""The paper's technique applied to a modern backbone: layer-wise convex
readout learning (dSSFN's ADMM) over a FROZEN random transformer — no
backpropagation anywhere, distributed across data-parallel workers.

This is the framework-level generalization described in DESIGN.md §5:
the transformer plays the role of SSFN's random matrices {R_l}; each
layer's features get a convex readout solved by consensus ADMM.

    PYTHONPATH=src python examples/torch_port/layerwise_readout.py [--device cpu]

The PyTorch twin of ``examples/layerwise_readout.py``.  The threefry key
draws ``repro``'s backbone (to a few f32 ulps), so it prints ``repro``'s
numbers; :func:`run` takes any weights, such as ``repro``'s own carried
across with ``repro_torch.convert.transformer_params_from_numpy``.  On the
card every readout solve launches the ``gram`` kernel.
"""
import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import admm
from repro_torch.core.readout import layerwise_backbone_fit
from repro_torch.models import blocks, build_model
from repro_torch.models.transformer import layer_views
from repro_torch.nn.layers import embed_lookup


def tap_layer_features(model, params, tokens):
    """Per-layer hidden states of the frozen backbone."""
    cfg = model.cfg
    x = embed_lookup(params["embed"], tokens)
    feats = [x]
    positions = torch.arange(x.shape[1], device=x.device)
    for layer_p in layer_views(params["layers"], cfg.num_layers):
        x, _, _ = blocks.apply_transformer_layer(layer_p, x, positions, cfg, None)
        feats.append(x)
    return feats  # list of (B, S, d)


def run(model, params, device) -> dict:
    """The readout fits over ``params``' frozen backbone; prints them and
    returns the printed numbers."""
    cfg = model.cfg
    # Synthetic sequence-classification task: label = planted function of
    # the token stream.
    rng = np.random.default_rng(0)
    b, s, q = 64, 32, 6
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = (tokens.sum(axis=1) + tokens[:, 0]) % q
    labels_t = torch.as_tensor(labels, device=device)
    t_onehot = torch.nn.functional.one_hot(labels_t, q).T.float()   # (Q, B)

    with torch.no_grad():
        feats = tap_layer_features(model, params, torch.as_tensor(tokens, device=device))
    # Mean-pool over the sequence -> one feature vector per example.
    pooled = [f.mean(dim=1).T.float() for f in feats]  # (d, B)

    fit = layerwise_backbone_fit(pooled, t_onehot, mu=1e-2, num_iters=80)
    print("layer-wise readout costs (deeper taps should help):")
    costs, accs = [], []
    for i, c in enumerate(fit.layer_costs.cpu().numpy()):
        pred = torch.argmax(fit.readouts[i] @ pooled[i], dim=0)
        acc = float((pred == labels_t).float().mean())
        costs.append(float(c))
        accs.append(acc)
        print(f"  tap {i}: cost {float(c):8.2f}  train-acc {acc:.3f}")

    # The same solve, decentralized over 4 workers with exact consensus —
    # verifying centralized equivalence at the framework level.
    y = pooled[-1]
    m = 4
    yw = y.reshape(y.shape[0], m, b // m).permute(1, 0, 2)
    tw = t_onehot.reshape(q, m, b // m).permute(1, 0, 2)
    res = admm.admm_ridge_consensus(yw, tw, mu=1e-2, eps_radius=2.0 * q, num_iters=200)
    gap = float(torch.linalg.norm(res.o_star - fit.readouts[-1])
                / torch.linalg.norm(fit.readouts[-1]))
    print(f"decentralized(M=4) vs centralized readout gap: {gap:.2e}")
    assert gap < 1e-2
    return {"costs": costs, "train_acc": accs, "gap": gap}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("stablelm_3b").reduced(layers=4, d_model=128)
    model = build_model(cfg)
    params = model.init(key=prng.PRNGKey(0), device=device)  # FROZEN random backbone
    return run(model, params, device)


if __name__ == "__main__":
    main()
