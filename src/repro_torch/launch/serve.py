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
It runs on ``cuda`` unless ``--device cpu`` is given; there is one card,
so the reference's ``--model-parallel`` is left out.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, synchronize
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.models.steps import make_serve_step


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
) -> dict:
    """Serve one batch of ``batch`` random prompts and return
    ``{"tokens": (batch, gen_len) int64 numpy ((batch, gen_len, nc) for an
    audio model), "prefill_s", "decode_s", "decode_tokens_per_s",
    "device"}``.  ``layers`` keeps the config's first ``layers`` layers.
    ``params`` replaces the seeded init (for example ``repro``'s weights,
    carried across with ``convert.transformer_params_from_numpy``,
    ``convert.hybrid_params_from_numpy`` or
    ``convert.xlstm_params_from_numpy``); the prompt is always drawn from
    ``numpy.random.default_rng(seed)`` as the reference draws it: the
    tokens, then a VLM's patch embeddings."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    rng = np.random.default_rng(seed)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    audio = cfg.family == "audio"
    tok_shape = (batch, prompt_len, cfg.num_codebooks) if audio else (batch, prompt_len)
    prompt = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, tok_shape), device=dev)}
    if cfg.family == "vlm":
        patches = rng.normal(size=(batch, cfg.num_patches, cfg.patch_dim))
        prompt["patch_embeds"] = torch.as_tensor(patches, dtype=torch.float32, device=dev)
    step_shape = (batch, 1, cfg.num_codebooks) if audio else (batch, 1)

    with torch.no_grad():
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, max_len=prompt_len + gen_len)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        step_fn = make_serve_step(model)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        generated = []
        t0 = time.perf_counter()
        for _ in range(gen_len):
            next_tok, logits, cache = step_fn(params, {"tokens": next_tok.reshape(step_shape)},
                                              cache)
            generated.append(next_tok)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    toks = torch.stack(generated, dim=1).cpu().numpy()
    rate = batch * gen_len / max(t_decode, 1e-9)
    print(
        f"{arch}: prefill {prompt_len} tok in {t_prefill:.2f}s; "
        f"decoded {gen_len} tok/seq x {batch} seqs in {t_decode:.2f}s "
        f"({rate:.1f} tok/s) on {dev.type}",
        flush=True,
    )
    return {"tokens": toks, "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tokens_per_s": rate, "device": dev.type}


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
    )
    print("sample tokens:", res["tokens"][0].ravel()[:16].tolist())
    return res


if __name__ == "__main__":
    main()
