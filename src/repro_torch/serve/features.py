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

``repro`` draws the ``rff``/``relu`` weights with ``jax.random``.  The
port serves them once it has a threefry PRNG that reproduces those
numbers bit for bit (ROADMAP, Queue 1: "threefry PRNG"); until then
:meth:`FeatureExtractor.materialize` raises for those kinds rather than
draw different weights.
"""
from __future__ import annotations

from dataclasses import dataclass

_KINDS = ("identity", "rff", "relu")


@dataclass
class FeatureExtractor:
    """A frozen, seeded, column-wise feature map ``(P, J) -> (D, J)``."""

    kind: str            # one of _KINDS
    dim: int = 0         # D; 0 for identity
    seed: int = 0

    def describe(self) -> str:
        if self.kind == "identity":
            return "identity"
        return f"{self.kind}:{self.dim}:{self.seed}"

    def output_dim(self, input_dim: int) -> int:
        return input_dim if self.kind == "identity" else self.dim

    def materialize(self, input_dim: int) -> "FeatureExtractor":
        """Bind this extractor to an input dimension."""
        if self.kind != "identity":
            raise NotImplementedError(
                f"feature extractor {self.describe()!r} draws its weights "
                "with jax.random; the port serves it once the threefry PRNG "
                "lands (ROADMAP, Queue 1: threefry PRNG)"
            )
        return self


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
