"""The system under test: ``repro_torch.dssfn.train``, driven as a user
drives it, with the cell's spec and the benchmark's inputs."""
from __future__ import annotations

from dataclasses import replace

import torch

from portbench.harness import check

#: The hand-written kernels a dSSFN train launches.
KERNELS = ("gram", "propagate_gram")


def build_kernels() -> None:
    """Build (first run in a checkout) or find the train's kernels, in the
    program's own build directory inside the checkout."""
    from repro_torch.kernels import _build

    for name in KERNELS:
        _build.load(name)


def train_spec(config: dict, traffic: dict, num_layers: int | None = None):
    """The ``dssfn.TrainSpec`` of a configuration under a traffic mix."""
    from repro_torch import dssfn
    from repro_torch.core import ssfn

    if config["dtype"] != "float32":
        raise ValueError(f"the port trains in float32, the config says {config['dtype']}")
    cfg = ssfn.SSFNConfig(
        input_dim=config["input_dim"],
        num_classes=config["num_classes"],
        num_layers=config["num_layers"] if num_layers is None else num_layers,
        hidden=config["hidden"],
        mu0=config["mu0"],
        mul=config["mul"],
        admm_iters=config["admm_iters"],
        eps_scale=config["eps_scale"],
        dtype=torch.float32,
    )
    return dssfn.TrainSpec(
        cfg=cfg, workers=config["workers"], policy=traffic["policy"],
        trace_every=traffic["trace_every"],
    )


def shallower(spec, num_layers: int):
    """``spec`` with its first ``num_layers`` layers after layer 0."""
    return replace(spec, cfg=replace(spec.cfg, num_layers=num_layers))


def train(spec, inputs) -> check.Outputs:
    """One whole train; returns once the card has finished it."""
    from repro_torch import dssfn

    result = dssfn.train(
        spec, inputs.x_workers, inputs.t_workers, r=inputs.r[: spec.cfg.num_layers]
    )
    if inputs.x_workers.is_cuda:
        torch.cuda.synchronize()
    # Each readout is a view of its layer's (M, Q, n) consensus stack:
    # keep a copy of the (Q, n) alone, not every worker's stack.
    return check.Outputs(tuple(o.clone() for o in result.params.o), result.log.admm_objective)
