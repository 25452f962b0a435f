"""dSSFN serving on the card: load exported stacks, serve them bucketed.

Centralized equivalence makes the stack that M workers trained one
feed-forward network; this package serves it:

- :mod:`repro_torch.serve.export` — ``repro``'s artifact format
  (``export_artifact`` / ``export_from_checkpoint`` / ``load_artifact``
  / ``is_valid_artifact``);
- :mod:`repro_torch.serve.engine` — :class:`ServeEngine`, device-resident
  weights and one cached forward program per (shape bucket, dtype),
  every propagation through the CUDA ``matmul_relu`` kernel on the card;
- :mod:`repro_torch.serve.batcher` — :class:`MicroBatcher`, synchronous
  micro-batching (``submit``/``flush``, max-batch + max-wait-µs);
- :mod:`repro_torch.serve.runtime` — :class:`ServeRuntime`, the
  clock-owning, failure-aware loop: bounded admission with load
  shedding, deadlines, poison isolation by bisection, retry + circuit
  breaker, hot reload that keeps the last good weights, a lifecycle
  with ``drain()``, and :class:`ManualClock` for deterministic drills;
- :mod:`repro_torch.serve.chaos` — :class:`ChaosInjector`, seeded fault
  injection (engine raises, latency spikes, clock skew, artifact
  corruption) that replays ``repro``'s schedule from the same seed;
- :mod:`repro_torch.serve.features` — the feature-spec grammar.

``launch/serve_dssfn.py`` is the CLI (``--runtime`` for the runtime).
"""
from repro_torch.serve.batcher import (
    COMPLETED,
    EXPIRED,
    FAILED,
    PENDING,
    REJECTED,
    TERMINAL_STATES,
    MicroBatcher,
    PendingResult,
    RequestError,
    pack_fifo,
    scatter_results,
    size_bucket,
)
from repro_torch.serve.chaos import (
    ChaosError,
    ChaosInjector,
    corrupt_artifact,
    parse_chaos,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.export import (
    ArtifactCorruptError,
    ServeArtifact,
    export_artifact,
    export_from_checkpoint,
    is_valid_artifact,
    load_artifact,
)
from repro_torch.serve.features import FeatureExtractor, parse_features
from repro_torch.serve.runtime import (
    DEGRADED,
    DRAINING,
    READY,
    STARTING,
    STOPPED,
    ManualClock,
    ServeRuntime,
    TransientEngineError,
    WallClock,
)

__all__ = [
    "ArtifactCorruptError",
    "COMPLETED",
    "ChaosError",
    "ChaosInjector",
    "DEGRADED",
    "DRAINING",
    "EXPIRED",
    "FAILED",
    "FeatureExtractor",
    "ManualClock",
    "MicroBatcher",
    "PENDING",
    "PendingResult",
    "READY",
    "REJECTED",
    "RequestError",
    "STARTING",
    "STOPPED",
    "ServeArtifact",
    "ServeEngine",
    "ServeRuntime",
    "TERMINAL_STATES",
    "TransientEngineError",
    "WallClock",
    "corrupt_artifact",
    "export_artifact",
    "export_from_checkpoint",
    "is_valid_artifact",
    "load_artifact",
    "pack_fifo",
    "parse_chaos",
    "parse_features",
    "scatter_results",
    "size_bucket",
]
