"""Continuous micro-batching for the dSSFN serving engine.

``submit()`` enqueues a request and returns a :class:`PendingResult`
immediately; the queue drains into coalesced engine batches under two
admission rules —

- **max-batch**: the moment the queued sample count reaches
  ``max_batch``, the queue flushes (a full bucket is ready);
- **max-wait**: a non-empty queue older than ``max_wait_us`` flushes on
  the next ``submit``.  ``max_wait_us=0`` means "never hold": every
  submit flushes immediately.

``flush()`` drains unconditionally.  The driver owns the clock, so this
layer is deterministic and synchronous: no threads.  Coalescing is FIFO;
each batch runs through the engine once and its result columns scatter
back to their requests.  Because the engine's forward is column-wise, a
coalesced request's results equal serving it alone, bit for bit, within
a bucket.  A request's completion stamp is taken after the device has
finished its batch.
"""
from __future__ import annotations

import time

import torch

from repro_torch._device import synchronize
from repro_torch.serve.engine import ServeEngine

#: Request lifecycle: one non-terminal state and four terminal ones.
PENDING = "pending"
COMPLETED = "completed"
FAILED = "failed"
REJECTED = "rejected"
EXPIRED = "expired"
TERMINAL_STATES = (COMPLETED, FAILED, REJECTED, EXPIRED)


class RequestError(RuntimeError):
    """A request reached a non-``completed`` terminal state; ``status``
    says which, ``reason`` carries the error payload."""

    def __init__(self, status: str, reason: str):
        self.status = status
        self.reason = reason
        super().__init__(f"request {status}: {reason}")


def size_bucket(n: int) -> int:
    """Power-of-two histogram bucket for a batch size (smallest power of
    two >= n)."""
    return 1 << max(0, int(n) - 1).bit_length()


class PendingResult:
    """A submitted request's future.

    ``status`` is one of ``pending | completed | failed | rejected |
    expired``; ``done()`` means terminal, ``ok()`` means completed.
    ``result()`` returns the (Q, j) logits when completed and raises
    :class:`RequestError` for the failure states.  ``latency_s`` is
    submit -> terminal on the owning layer's clock (wall by default).
    """

    __slots__ = (
        "num_samples", "submitted_at", "completed_at", "deadline",
        "status", "error", "_value",
    )

    def __init__(self, num_samples: int, *, now: float | None = None):
        self.num_samples = num_samples
        self.submitted_at = time.perf_counter() if now is None else now
        self.completed_at: float | None = None
        #: Absolute clock time this request must be served by (None = no
        #: deadline).
        self.deadline: float | None = None
        self.status = PENDING
        #: Error payload for the failed/rejected/expired states.
        self.error: str | None = None
        self._value = None

    def done(self) -> bool:
        """True once the request reached ANY terminal state."""
        return self.status != PENDING

    def ok(self) -> bool:
        return self.status == COMPLETED

    def result(self):
        """The (Q, j) logits for this request's samples.  Raises
        :class:`RequestError` if the request failed / was rejected /
        expired, and ``RuntimeError`` while still pending."""
        if self.status == COMPLETED:
            return self._value
        if self.status == PENDING:
            raise RuntimeError(
                "request not served yet: flush() the batcher (or submit "
                "enough traffic to trip its admission rules)"
            )
        raise RequestError(self.status, self.error or "")

    @property
    def latency_s(self) -> float:
        if not self.done():
            raise RuntimeError("request not served yet")
        return self.completed_at - self.submitted_at

    # -- terminal transitions (owning layer only) ----------------------
    def _terminal(self, status: str, *, now: float | None = None) -> None:
        if self.done():
            raise RuntimeError(
                f"request already terminal ({self.status}), cannot "
                f"transition to {status}"
            )
        self.status = status
        self.completed_at = time.perf_counter() if now is None else now

    def _complete(self, value, *, now: float | None = None) -> None:
        self._value = value
        self._terminal(COMPLETED, now=now)

    def _fail(self, reason: str, *, now: float | None = None) -> None:
        self.error = str(reason)
        self._terminal(FAILED, now=now)

    def _reject(self, reason: str, *, now: float | None = None) -> None:
        self.error = str(reason)
        self._terminal(REJECTED, now=now)

    def _expire(self, reason: str, *, now: float | None = None) -> None:
        self.error = str(reason)
        self._terminal(EXPIRED, now=now)


class MicroBatcher:
    """Coalesce concurrent requests into bucketed engine batches.

    batcher = MicroBatcher(engine, max_batch=32, max_wait_us=200.0)
    handles = [batcher.submit(x) for x in requests]
    batcher.flush()                      # drain the tail
    outs = [h.result() for h in handles]
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        max_batch: int | None = None,
        max_wait_us: float = 0.0,
    ):
        if max_batch is None:
            max_batch = engine.max_batch
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self._queue: list[tuple[torch.Tensor, PendingResult]] = []
        self._queued_samples = 0
        self._oldest_at: float | None = None
        # Admission telemetry, O(log max_batch) for a service's lifetime:
        # ``batch_samples`` / ``batches`` give the mean batch size and
        # ``batch_size_hist`` is the power-of-two histogram.
        self.stats = {
            "requests": 0,
            "samples": 0,
            "batches": 0,
            "flushes": 0,
            "batch_samples": 0,
            "batch_size_hist": {},
        }

    # ------------------------------------------------------------------
    def pending(self) -> int:
        """Queued-but-unserved sample count."""
        return self._queued_samples

    def mean_batch_size(self, *, since: dict | None = None) -> float:
        """Mean coalesced batch size, optionally relative to an earlier
        ``dict(batcher.stats)`` snapshot (the launcher's post-warmup
        window)."""
        batches = self.stats["batches"]
        samples = self.stats["batch_samples"]
        if since is not None:
            batches -= since.get("batches", 0)
            samples -= since.get("batch_samples", 0)
        return samples / batches if batches else 0.0

    def _record_batch(self, size: int) -> None:
        self.stats["batches"] += 1
        self.stats["batch_samples"] += size
        bucket = size_bucket(size)
        hist = self.stats["batch_size_hist"]
        hist[bucket] = hist.get(bucket, 0) + 1

    def submit(self, x) -> PendingResult:
        """Enqueue one request (column-stacked ``(P, j)``, or ``(P,)``
        for a single sample; a tensor or an array) and return its
        handle.  May flush the queue if an admission rule trips —
        including the queue this request just joined."""
        x = torch.as_tensor(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2:
            raise ValueError(
                f"requests are column-stacked (P, j) arrays, got shape "
                f"{tuple(x.shape)}"
            )
        handle = PendingResult(x.shape[1])
        if not self._queue:
            self._oldest_at = handle.submitted_at
        self._queue.append((x, handle))
        self._queued_samples += x.shape[1]
        self.stats["requests"] += 1
        self.stats["samples"] += x.shape[1]
        if self._queued_samples >= self.max_batch:
            self.flush()
        elif (
            self._oldest_at is not None
            and (time.perf_counter() - self._oldest_at) * 1e6
            >= self.max_wait_us
        ):
            self.flush()
        return handle

    def flush(self) -> int:
        """Drain the queue: FIFO-pack into <= ``max_batch``-sample
        batches, run each through the engine once, wait for the device,
        scatter the result columns back.  Returns the number of requests
        served."""
        if not self._queue:
            return 0
        queue, self._queue = self._queue, []
        self._queued_samples = 0
        self._oldest_at = None
        self.stats["flushes"] += 1

        for batch in pack_fifo(queue, self.max_batch):
            xs = [x for x, _ in batch]
            xcat = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
            out = self.engine.forward(xcat)
            synchronize(self.engine.device)
            self._record_batch(xcat.shape[1])
            scatter_results(batch, out)
        return len(queue)


def pack_fifo(
    queue: list[tuple[torch.Tensor, PendingResult]], max_batch: int
) -> list[list[tuple[torch.Tensor, PendingResult]]]:
    """FIFO-pack queued requests into batches of <= ``max_batch``
    samples (a request larger than ``max_batch`` gets its own batch;
    the engine chunks it)."""
    batches: list[list[tuple[torch.Tensor, PendingResult]]] = [[]]
    size = 0
    for item in queue:
        j = item[0].shape[1]
        if batches[-1] and size + j > max_batch:
            batches.append([])
            size = 0
        batches[-1].append(item)
        size += j
    return batches if batches[0] else []


def scatter_results(
    batch: list[tuple[torch.Tensor, PendingResult]], out,
    *, now: float | None = None,
) -> None:
    """Scatter a coalesced batch's result columns back to its handles."""
    start = 0
    for x, handle in batch:
        j = x.shape[1]
        handle._complete(out[:, start:start + j], now=now)
        start += j
