"""Faults planted under the timed path, to show the check fails them.

Each is a context manager that rebinds one attribute of ``repro_torch``
for the length of the block and puts back what it found:

- ``unchanged``: every layer's ADMM returns the state it started from
  (Z = 0), the iterations' traces as they were;
- ``half_mix``: every consensus averages half of the workers, the mean
  taken over that half, and leaves the rest out;
- ``no_exchange``: every consensus returns each worker's own value, no
  exchange between workers;
- ``altered``: the largest entry of each layer's readout is negated
  where the layer step returns it.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_mix", "no_exchange", "altered")


@contextlib.contextmanager
def _rebound(owner, attr, make):
    original = owner.__dict__[attr]
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def planted(fault: str, policy):
    """The context manager that plants ``fault`` for trains under
    ``policy``."""
    from repro_torch.core import admm, engine

    if fault == "unchanged":
        def make(original):
            def iterations(backend, a, chol, y_m, t_m, z_init, **kw):
                _, traces = original(backend, a, chol, y_m, t_m, z_init, **kw)
                zeros = torch.zeros_like(a)
                return (zeros, z_init.to(a.dtype).expand_as(a), zeros), traces
            return iterations
        return _rebound(admm, "worker_admm_iterations", make)
    if fault in ("half_mix", "no_exchange"):
        def make(original):
            def mix(self, x, state, ctx):
                if fault == "no_exchange":
                    return x, state
                half = x[: x.shape[0] // 2].mean(dim=0, keepdim=True)
                return half.expand_as(x).contiguous(), state
            return mix
        return _rebound(type(policy), "mix", make)
    if fault == "altered":
        def make(original):
            def step(*args, **kw):
                out = original(*args, **kw)
                o = out.o_star.clone(memory_format=torch.contiguous_format)
                flat = o.view(-1)
                i = int(flat.abs().argmax())
                flat[i] = -flat[i]
                return out._replace(o_star=o)
            return step
        return _rebound(engine, "fused_layer_step", make)
    raise ValueError(f"no fault {fault!r}; known: {FAULTS}")
