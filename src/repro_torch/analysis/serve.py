"""Contracts for the serving surface.

Port of ``repro/analysis/serve.py``.  The serving engine promises two
things spmdlint checks from one run of each bucket program
(:meth:`ServeEngine.lowering_texts`, which leaves the engine's program
cache as it was):

- **zero collectives** (``serve-collective``): a bucket program is a
  single-device forward, features -> propagate stack -> readout.  A
  collective during it means training-side SPMD machinery leaked into
  the serving path.  One has run when a ``c10d`` op shows in the record,
  or when :data:`repro_torch.launch.mesh.PROCESS_TALLY` moved: the
  transport calls gloo and NCCL on their process-group objects, below
  the dispatcher, so only its own tally sees those.
- **dtype discipline** (``numerics-accum`` via the shared numerics
  lint): the forward must accumulate in f32 even when weights ride in
  half precision, through the feature extractors, the propagation
  (``matmul_relu``, f32 accumulators on the card) and the readout.

:func:`check_serve_contract` runs every configured bucket, checks that
the probe left ``lowerings``, ``cache_hits`` and ``entries`` unchanged,
and verifies the engine's normalized ``cache_info()`` schema.
:func:`synthetic_serve_engine` builds a small valid in-memory artifact
from the reference's seeded numbers, so the lint needs no training run
and no disk.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ssfn as ssfn_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.export import ARTIFACT_VERSION, ServeArtifact

from .findings import LintFinding
from .numerics import lint_record
from .retrace import check_cache_info_schema

#: Feature specs the default serve lint sweeps: the identity path plus
#: one of each extractor kind, covering every extractor branch.
DEFAULT_FEATURE_SPECS = (None, "rff:24", "relu:24")


def synthetic_serve_engine(
    *,
    num_classes: int = 4,
    input_dim: int = 6,
    num_layers: int = 2,
    extra_nodes: int = 8,
    features: str | None = None,
    dtype: torch.dtype = torch.float32,
    buckets: tuple[int, ...] = (1, 4),
    seed: int = 0,
    device=None,
) -> ServeEngine:
    """A ServeEngine over a small synthetic (valid shape-chain) artifact:
    O_0 (Q,P), R_l ((n-2Q), fan_in), O_l (Q,n) with n = 2Q + extra; the
    reference's ``default_rng(seed)`` numbers, in its order."""
    rng = np.random.default_rng(seed)
    q, p = num_classes, input_dim
    n = 2 * q + extra_nodes
    if features is not None:
        from repro_torch.serve.features import parse_features

        p = parse_features(features).output_dim(input_dim)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    o = [draw((q, p))]
    r = []
    fan_in = p
    for _ in range(num_layers):
        r.append(draw((extra_nodes, fan_in)))
        fan_in = n
        o.append(draw((q, n)))
    artifact = ServeArtifact(
        params=ssfn_lib.SSFNParams(o=tuple(o), r=tuple(r)),
        num_classes=q,
        input_dim=p,
        activation="relu",
        features=features,
        version=ARTIFACT_VERSION,
        manifest={"source": "repro_torch.analysis.serve synthetic"},
    )
    return ServeEngine(artifact, buckets=buckets, dtype=dtype, device=device)


def check_serve_record(texts: dict, *, subject: str) -> list[LintFinding]:
    """Lint one bucket program's :meth:`ServeEngine.lowering_texts`:
    dtype discipline in its record, and zero collectives in the record
    and in the transports' tally (the reference's ``check_serve_texts``,
    which reads the compiled HLO)."""
    program = texts["program"]
    findings = lint_record(program, subject=subject)
    counts = dict(texts.get("collective_counts", {}))
    for call in program.calls:
        if call.is_collective:
            counts[call.name] = counts.get(call.name, 0) + 1
    if counts:
        findings.append(LintFinding(
            check="serve-collective",
            subject=subject,
            message=(
                f"serving bucket program ran collectives {counts} — "
                "the serve forward is single-device; SPMD machinery "
                "leaked into the request path"
            ),
            details={"collective_counts": counts},
        ))
    return findings


def check_serve_contract(
    engine: ServeEngine,
    *,
    subject: str,
    buckets: tuple[int, ...] | None = None,
    request_dim: int | None = None,
) -> list[LintFinding]:
    """Run every requested bucket of ``engine`` once and check the
    serving contracts; also verifies the probe left the program cache
    untouched and the normalized ``cache_info()`` schema holds."""
    findings: list[LintFinding] = []
    before = engine.cache_info()
    for bucket in buckets or engine.buckets:
        texts = engine.lowering_texts(bucket=bucket, request_dim=request_dim)
        findings.extend(
            check_serve_record(texts, subject=f"{subject}[bucket={bucket}]")
        )
    info = engine.cache_info()
    moved = {
        k: (before[k], info[k]) for k in ("lowerings", "cache_hits", "entries")
        if before[k] != info[k]
    }
    if moved:
        findings.append(LintFinding(
            check="serve-probe-purity",
            subject=subject,
            message=(
                "lowering_texts() touched the engine's program cache — "
                "probes must be side-effect free on the serving hot path"
            ),
            details=moved,
        ))
    findings.extend(check_cache_info_schema(info, subject=subject))
    return findings


def check_serve_surface(
    *,
    feature_specs: tuple[str | None, ...] = DEFAULT_FEATURE_SPECS,
    buckets: tuple[int, ...] = (1, 4),
    device=None,
) -> list[LintFinding]:
    """The ``lint_dssfn --checks serve`` entry point: sweep synthetic
    engines across the feature-extractor grammar and lint every bucket
    program."""
    findings: list[LintFinding] = []
    for spec in feature_specs:
        engine = synthetic_serve_engine(features=spec, buckets=buckets, device=device)
        findings.extend(check_serve_contract(
            engine, subject=f"serve:{spec or 'identity'}",
        ))
    return findings
