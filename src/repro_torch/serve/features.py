"""Frozen feature extractors for the serving path.

The artifact records the extractor SPEC (a string, deterministic given
its seed), so a request carries raw inputs and the engine reproduces the
training featurization in front of the stack.

Spec grammar (``parse_features``), the same as ``repro``'s::

    identity              raw inputs straight through (the default; also
                          spelled None)
    rff:D[:seed]          D random Fourier features
                          sqrt(2/D) * cos(W x + b), W ~ N(0, 1),
                          b ~ U[0, 2*pi), seeded
    relu:D[:seed]         D-dim frozen random ReLU projection
                          relu(W x), W ~ N(0, 1/sqrt(P))

Extractors are column-wise maps on column-stacked ``(P, J)`` inputs:
each output column depends only on its input column, so the serving
engine's zero padding never reaches a real column.

The weights are ``repro``'s: :mod:`repro_torch.prng` draws them from
``PRNGKey(seed)`` as ``jax.random`` does (the uniform ``b`` bit for bit,
the normal ``W`` to a few f32 ulps), on the CPU, once the input
dimension is known (:meth:`FeatureExtractor.materialize`).  They are
pure functions of ``(spec, input_dim)`` and are moved to each device as
they are, so train-side and serve-side materializations are
bit-identical on any device.  The products are plain ``torch.matmul``,
as ``repro``'s are plain ``jnp`` (no kernel there).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import exact_div

_KINDS = ("identity", "rff", "relu")


@dataclass
class FeatureExtractor:
    """A frozen, seeded, column-wise feature map ``(P, J) -> (D, J)``."""

    kind: str            # one of _KINDS
    dim: int = 0         # D; 0 for identity
    seed: int = 0
    #: Materialized parameters on the CPU (None until the input dim is
    #: known; the identity extractor never materializes anything).
    params: tuple[torch.Tensor, ...] | None = field(default=None, repr=False)
    input_dim: int | None = field(default=None, repr=False)
    _placed: dict = field(default_factory=dict, repr=False, compare=False)

    def describe(self) -> str:
        if self.kind == "identity":
            return "identity"
        return f"{self.kind}:{self.dim}:{self.seed}"

    def output_dim(self, input_dim: int) -> int:
        return input_dim if self.kind == "identity" else self.dim

    def materialize(self, input_dim: int) -> "FeatureExtractor":
        """Bind this extractor to an input dimension, drawing its frozen
        weights.  Deterministic in (kind, dim, seed, input_dim)."""
        if self.kind == "identity":
            self.input_dim = input_dim
            return self
        if self.input_dim is not None and self.input_dim != input_dim:
            raise ValueError(
                f"extractor {self.describe()} materialized for input_dim="
                f"{self.input_dim}, got {input_dim}"
            )
        if self.params is None:
            kw, kb = prng.split(prng.PRNGKey(self.seed))
            w = torch.from_numpy(prng.normal(kw, (self.dim, input_dim)))
            if self.kind == "rff":
                b = torch.from_numpy(
                    prng.uniform(kb, (self.dim, 1), minval=0.0, maxval=2.0 * math.pi)
                )
                self.params = (w, b)
            else:  # relu
                self.params = (exact_div(w, math.sqrt(input_dim)),)
            self.input_dim = input_dim
        return self

    def params_on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The materialized weights on ``device`` (moved once)."""
        if device not in self._placed:
            self._placed[device] = tuple(p.to(device) for p in self.params)
        return self._placed[device]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to column-stacked ``(P, J)`` inputs on their device."""
        if self.kind == "identity":
            return x
        if self.params is None:
            self.materialize(x.shape[0])
        if self.kind == "rff":
            w, b = self.params_on(x.device)
            scale = float(np.sqrt(np.float32(2.0 / self.dim)))
            return scale * torch.cos(w @ x + b)
        (w,) = self.params_on(x.device)
        return torch.relu(w @ x)


def parse_features(spec: str | None) -> FeatureExtractor | None:
    """``identity | rff:D[:seed] | relu:D[:seed]`` -> extractor.

    None and ``"identity"`` both mean raw inputs (returned as None so
    callers can treat "no extractor" uniformly).
    """
    if spec is None or spec == "identity":
        return None
    head, _, rest = spec.partition(":")
    if head not in _KINDS:
        raise ValueError(
            f"unknown feature spec {spec!r}; grammar: identity | "
            "rff:D[:seed] | relu:D[:seed]"
        )
    parts = rest.split(":") if rest else []
    if not parts or not parts[0]:
        raise ValueError(f"feature spec {spec!r} is missing its dimension D")
    try:
        dim = int(parts[0])
        seed = int(parts[1]) if len(parts) > 1 else 0
    except ValueError as e:
        raise ValueError(f"bad feature spec {spec!r}: {e}") from e
    if dim < 1:
        raise ValueError(f"feature spec {spec!r}: D must be >= 1")
    if len(parts) > 2:
        raise ValueError(f"feature spec {spec!r} has trailing segments")
    return FeatureExtractor(kind=head, dim=dim, seed=seed)
