"""ServeEngine: device-resident dSSFN weights, shape-bucketed batched forward.

The serving hot path is ``y_{l+1} = relu(W_{l+1} y_l)`` over the
assembled weights, then the readout ``O_L y_L``:

- **Shape bucketing.**  Each batch is zero-padded to the smallest
  configured bucket that fits (batches above the largest bucket are
  chunked), so the whole request distribution runs a small fixed set of
  shapes.  Each ``(bucket, input dtype)`` has one cached forward program;
  its first use counts as a *lowering*, and ``cache_info()`` keeps
  ``repro``'s schema.  (``repro`` traces one XLA program per entry; the
  port's entry is the eager bucket program, the place a per-bucket CUDA
  graph goes later.)
- **Bit-exact padding.**  Every op is column-wise, and the CUDA
  ``matmul_relu`` kernel sums each output element in one fixed order
  whatever the batch width, so padded, bucketed and micro-batched
  forwards return the same bits for the real columns within a bucket.
  (An ``rff``/``relu`` feature extractor runs ``torch.matmul`` in front
  of the stack, whose column bits may depend on the batch width.)
- **Device-resident weights.**  The assembled ``W_l`` and ``O_L`` live on
  the engine's device; :meth:`reload` copies a same-shape artifact into
  them in place and rejects shape or feature changes.
- **Kernel routing.**  There is no switch: on the card every propagation
  launches the hand-written ``matmul_relu`` kernel; on the CPU it takes
  the plain version.  The runtime's circuit breaker leaves the route as
  it is (``repro``'s switches its engine to einsum; see
  :mod:`repro_torch.serve.runtime`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import torch

from repro_torch._device import resolve_device
from repro_torch.core import ssfn as ssfn_lib
from repro_torch.kernels.matmul_relu import matmul_relu
from repro_torch.serve.export import ServeArtifact, load_artifact
from repro_torch.serve.features import parse_features

#: Default shape-bucket ladder: powers of two.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: Bound on cached bucket programs (FIFO eviction).
_EXEC_CACHE_SIZE = 64


class ServeEngine:
    """Serve a trained dSSFN stack with bucketed batched inference.

    engine = ServeEngine("artifact_dir", buckets=(1, 8, 32))   # on cuda
    logits = engine.forward(x)          # x: (P_raw, J) column-stacked
    """

    def __init__(
        self,
        artifact: ServeArtifact | str,
        *,
        buckets: tuple[int, ...] | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if isinstance(artifact, str):
            artifact = load_artifact(artifact)
        if not isinstance(artifact, ServeArtifact):
            raise TypeError(
                f"expected a ServeArtifact or artifact path, got "
                f"{type(artifact).__name__}"
            )
        self.artifact = artifact
        self.num_classes = artifact.num_classes
        self.dtype = dtype

        buckets = tuple(sorted(set(buckets or DEFAULT_BUCKETS)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = buckets
        self.max_batch = buckets[-1]

        self.extractor = parse_features(artifact.features)
        #: Rows requests arrive with (the extractor's input when one is
        #: configured, else the stack's own input dim).
        self.request_dim: int | None = (
            artifact.input_dim if self.extractor is None else None
        )

        self._weights, self._o_last = self._assemble(artifact)

        self._exec_cache: OrderedDict[Hashable, Callable] = OrderedDict()
        self.lowerings = 0
        self.cache_hits = 0

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------
    def _assemble(self, artifact: ServeArtifact):
        ws = ssfn_lib.assemble_weights(artifact.params, artifact.num_classes)

        def put(t):
            return t.to(device=self.device, dtype=self.dtype).contiguous()

        return tuple(put(w) for w in ws), put(artifact.params.o[-1])

    def reload(self, artifact: ServeArtifact | str) -> None:
        """Hot-swap a newer artifact: same-shape weights are copied into
        the device-resident tensors in place; a shape or feature change
        is rejected — deploy those as a new engine."""
        if isinstance(artifact, str):
            artifact = load_artifact(artifact)
        new_w = ssfn_lib.assemble_weights(artifact.params, artifact.num_classes)
        old_shapes = [tuple(w.shape) for w in self._weights]
        old_shapes.append(tuple(self._o_last.shape))
        new_shapes = [tuple(w.shape) for w in new_w]
        new_shapes.append(tuple(artifact.params.o[-1].shape))
        if old_shapes != new_shapes or artifact.features != self.artifact.features:
            raise ValueError(
                f"reload shape/feature mismatch: engine serves {old_shapes} "
                f"(features={self.artifact.features!r}), artifact has "
                f"{new_shapes} (features={artifact.features!r})"
            )
        for dst, src in zip(self._weights, new_w):
            dst.copy_(src)
        self._o_last.copy_(artifact.params.o[-1])
        self.artifact = artifact

    # ------------------------------------------------------------------
    # Bucketing
    # ------------------------------------------------------------------
    def bucket_for(self, batch: int) -> int:
        """Smallest configured bucket that fits ``batch`` (the largest
        bucket for anything bigger — ``forward`` chunks those)."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        for b in self.buckets:
            if batch <= b:
                return b
        return self.max_batch

    def _chunks(self, j: int) -> list[int]:
        """Split a batch of ``j`` columns into per-program chunk sizes."""
        out, left = [], j
        while left > self.max_batch:
            out.append(self.max_batch)
            left -= self.max_batch
        out.append(left)
        return out

    # ------------------------------------------------------------------
    # Bucket programs
    # ------------------------------------------------------------------
    def _executable(self, bucket: int, dtype: torch.dtype) -> Callable:
        key = (int(bucket), str(dtype).removeprefix("torch."))
        program = self._exec_cache.get(key)
        if program is not None:
            self.cache_hits += 1
            return program
        self.lowerings += 1
        program = self._forward_program
        self._exec_cache[key] = program
        while len(self._exec_cache) > _EXEC_CACHE_SIZE:
            self._exec_cache.popitem(last=False)
        return program

    def _forward_program(self, x: torch.Tensor) -> torch.Tensor:
        """The bucket program body: features, then propagate the stack,
        then read out."""
        y = x.to(self.dtype)
        if self.extractor is not None:
            y = self.extractor(y).to(self.dtype)
        y = y.contiguous()
        for w in self._weights:
            y = matmul_relu(w, y)
        return self._o_last @ y

    def lowering_texts(
        self,
        *,
        bucket: int | None = None,
        dtype: torch.dtype | None = None,
        request_dim: int | None = None,
    ) -> dict:
        """Run one padded bucket of zeros through the bucket program once
        under :func:`repro_torch.analysis.numerics.recording` and return
        ``{"record": ..., "program": ..., "collective_counts": ...}``: the
        rendered record (one line per call), the record itself, and the
        collectives any transport of this process carried meanwhile.  The
        probe surface of :mod:`repro_torch.analysis.serve`, mirroring
        ``ConsensusBackend.lowering_texts``.  It calls the program body
        directly, never :meth:`_executable`, so ``cache_info()`` stays as
        it was.  (``repro``'s lowers without running and returns program
        texts; the port has none to return.)"""
        from repro_torch.analysis.numerics import recording
        from repro_torch.launch.mesh import PROCESS_TALLY, moved

        if bucket is None:
            bucket = self.buckets[0]
        if bucket not in self.buckets:
            raise ValueError(
                f"bucket {bucket} not in configured buckets {self.buckets}"
            )
        dtype = self.dtype if dtype is None else dtype
        if request_dim is None:
            request_dim = (
                self.request_dim
                if self.request_dim is not None
                else self.artifact.input_dim
            )
        self._materialize_features(request_dim)
        x = torch.zeros((request_dim, int(bucket)), dtype=dtype, device=self.device)
        before = dict(PROCESS_TALLY)
        with recording() as record:
            self._forward_program(x)
        return {"record": record.render(), "program": record,
                "collective_counts": moved(PROCESS_TALLY, before)}

    def cache_info(self) -> dict:
        """Bucket-program counters in ``repro``'s schema
        (``entries``/``buckets``/``lowerings``/``cache_hits``/``keys``)."""
        return {
            "entries": len(self._exec_cache),
            "buckets": [k[0] for k in self._exec_cache],
            "lowerings": self.lowerings,
            "cache_hits": self.cache_hits,
            "keys": [repr(k) for k in self._exec_cache],
        }

    def describe(self) -> str:
        dtype = str(self.dtype).removeprefix("torch.")
        return (
            f"ServeEngine({self.artifact.describe()}, buckets="
            f"{list(self.buckets)}, device={self.device}, dtype={dtype})"
        )

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _materialize_features(self, request_dim: int) -> None:
        if self.extractor is None:
            return
        self.extractor.materialize(request_dim)
        if self.extractor.output_dim(request_dim) != self.artifact.input_dim:
            raise ValueError(
                f"feature extractor {self.extractor.describe()} emits "
                f"{self.extractor.output_dim(request_dim)}-dim features, "
                f"stack expects {self.artifact.input_dim}"
            )
        self.request_dim = request_dim

    def _forward_bucket(self, x: torch.Tensor) -> torch.Tensor:
        """One padded bucket through its cached program.
        x: (P, j) on the device with j <= max_batch; returns (Q, j)."""
        j = x.shape[1]
        bucket = self.bucket_for(j)
        program = self._executable(bucket, x.dtype)
        if j < bucket:
            padded = torch.zeros(
                (x.shape[0], bucket), dtype=x.dtype, device=self.device
            )
            padded[:, :j] = x
            return program(padded)[:, :j]
        return program(x)

    def forward(self, x) -> torch.Tensor:
        """Logits ``O_L y_L`` on the engine's device for column-stacked
        requests ``x`` (a tensor or array): (P, J) -> (Q, J); a single
        sample may arrive as (P,)."""
        x = torch.as_tensor(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2:
            raise ValueError(
                f"requests are column-stacked (P, J) arrays, got shape "
                f"{tuple(x.shape)}"
            )
        self._materialize_features(x.shape[0])
        expect = self.request_dim
        if expect is not None and x.shape[0] != expect:
            raise ValueError(
                f"request has {x.shape[0]} feature rows, engine serves "
                f"{expect} ({self.artifact.describe()})"
            )
        x = x.to(self.device)
        j = x.shape[1]
        if j <= self.max_batch:
            return self._forward_bucket(x)
        outs, start = [], 0
        for size in self._chunks(j):
            outs.append(self._forward_bucket(x[:, start:start + size]))
            start += size
        return torch.cat(outs, dim=1)

    __call__ = forward

    def classify(self, x) -> torch.Tensor:
        """argmax labels for column-stacked requests."""
        return torch.argmax(self.forward(x), dim=0)
