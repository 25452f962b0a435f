"""Serve a small model with batched requests: prefill + greedy decode for
three architecture families (dense/SWA, xLSTM recurrent, Mamba2 hybrid),
then the dSSFN train -> export -> serve path.

    PYTHONPATH=src python examples/torch_port/serve_decode.py [--device cpu]

The PyTorch twin of ``examples/serve_decode.py``.  The zoo models' weights
are PyTorch's seeded draw (their lines print times only); the dSSFN stack
is ``repro``'s, from the same threefry keys.  On the card every batch of
the stack is served through the ``matmul_relu`` kernel.
"""
import argparse
import tempfile

from repro_torch._device import resolve_device
from repro_torch.launch.serve import serve


def serve_dssfn_stack(device) -> dict:
    """Train a small dSSFN across 4 workers, export the stack as a
    serving artifact, and serve it with compile-once batched inference —
    the paper's centralized equivalence as a deploy story: the
    decentralized training run yields ONE model, and the serving engine's
    output is bit-identical to the training-time propagate path."""
    import torch

    from repro_torch import dssfn, prng
    from repro_torch.core import ssfn
    from repro_torch.data import make_classification, partition_by_spec
    from repro_torch.serve import MicroBatcher, ServeEngine, export_artifact

    data = make_classification(
        key=prng.PRNGKey(0), device=device,
        num_train=256, num_test=64, input_dim=8, num_classes=3,
    )
    xw, tw = partition_by_spec(data.x_train, data.t_train, 4, "iid")
    cfg = ssfn.SSFNConfig(
        input_dim=8, num_classes=3, num_layers=2, hidden=20, admm_iters=30
    )
    result = dssfn.train(
        dssfn.TrainSpec(cfg=cfg, backend="simulated", workers=4),
        xw, tw, key=prng.PRNGKey(1),
    )

    with tempfile.TemporaryDirectory() as tmp:
        artifact = f"{tmp}/stack"
        export_artifact(artifact, result)

        engine = ServeEngine(artifact, buckets=(1, 8, 32), device=device)
        print(engine.describe())

        # Single requests coalesce into bucketed batches; results scatter
        # back per request, bit-identical to serving each alone.
        batcher = MicroBatcher(engine, max_batch=8, max_wait_us=500.0)
        x = data.x_test.cpu().numpy()
        handles = [batcher.submit(x[:, i:i + 1]) for i in range(16)]
        batcher.flush()
        logits = torch.cat([h.result() for h in handles], dim=1)

        ref = ssfn.predict(result.params, data.x_test[:, :16], 3)
        assert torch.equal(logits, ref), "serving != training"
        acc = float(
            (logits.argmax(0) == data.y_test[:16]).float().mean()
        )
        info = engine.cache_info()
        print(
            f"dssfn: served 16 requests in {info['lowerings']} lowerings "
            f"({batcher.stats['batches']} batches), bit-exact vs training "
            f"propagate, acc={acc:.3f}"
        )
    return {"requests": len(handles), "lowerings": info["lowerings"],
            "batches": batcher.stats["batches"], "acc": acc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    served = {}
    for arch in ("h2o_danube3_4b", "xlstm_350m", "zamba2_2_7b"):
        served[arch] = serve(arch, batch=4, prompt_len=48, gen_len=16, reduced=True,
                             device=device)
    return {"served": served, "dssfn": serve_dssfn_stack(device)}


if __name__ == "__main__":
    main()
