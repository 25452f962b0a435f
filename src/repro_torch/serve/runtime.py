"""ServeRuntime: the clock-owning, failure-aware serving loop.

Port of ``repro/serve/runtime.py``.  :class:`~repro_torch.serve.batcher.
MicroBatcher` is caller-clocked and failure-naive: the caller owns the
clock, one poison request fails every coalesced neighbor, and the queue
is unbounded.  The runtime owns the clock and wraps the request path in
a failure-handling stack:

- **Clock ownership.**  A :class:`WallClock` runtime runs a timer
  thread that flushes every ``flush_interval_s``; a :class:`ManualClock`
  runtime is driven by explicit ``tick()`` / ``clock.advance()`` calls,
  so every behavior below replays exactly from a seed.
- **Bounded admission.**  ``max_pending_samples`` /
  ``max_pending_requests`` cap the queue; overflow is shed as a
  ``rejected`` handle with an ``overloaded: ...`` reason.
- **Deadlines.**  Per-request (or runtime-default) deadlines; an expired
  request is shed at admission or before a flush and never reaches the
  engine.
- **Poison isolation.**  Non-finite or wrong-shape inputs are rejected
  at admission, on the host.  An engine exception fails only its batch,
  and unless the error is marked transient the runtime bisects the batch
  to quarantine the one offending request.
- **Retry + circuit breaker.**  Transient engine errors retry with
  exponential backoff.  ``breaker_threshold`` consecutive top-level
  batch failures open the circuit: queued work waits, and after
  ``breaker_cooldown_s`` a half-open probe batch decides re-close or
  re-open.  The engine's route does not change: on the card it stays
  the ``matmul_relu`` kernel.  (``repro``'s breaker also switches its
  engine from the kernel to einsum and reports ``kernels-disabled``;
  the port records that only on the CPU, where both of ``repro``'s
  routes are the one plain function, so a CPU drill's events and state
  match ``repro``'s.)  A failed :meth:`reload` keeps serving the last
  good weights (``stale-weights``).
- **Lifecycle.**  ``STARTING -> READY <-> DEGRADED -> DRAINING ->
  STOPPED``; :meth:`drain` stops admitting, serves the queue and fails
  what is left only when ``drain_timeout_s`` runs out.

On the card, requests stay on the host until their batch is formed: the
checks run on numpy (a request that arrives as a card tensor is copied
to the host once, which waits for the card's queue), each coalesced
batch is concatenated on the host and copied to the card once, and the device is synchronized inside the
retry loop, so an asynchronous launch error reaches the retry and the
breaker and ``completed_at`` is the card's finish time.  One lock
serializes the timer thread against submitters; all work stays on the
current CUDA stream.  A sticky CUDA error (an illegal address) poisons
the context: the retries fail alike, its batches fail and
:meth:`drain` sheds the rest.

Every handle reaches a terminal state (``completed/failed/rejected/
expired``), and a completed result equals an unbatched engine forward
within a bucket.  A completed handle holds a column slice
of its batch's output tensor, so keeping one handle keeps that batch's
output alive.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch._device import synchronize
from repro_torch.serve.batcher import (
    PendingResult,
    pack_fifo,
    scatter_results,
    size_bucket,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.export import ArtifactCorruptError

# Lifecycle states.
STARTING = "STARTING"
READY = "READY"
DEGRADED = "DEGRADED"
DRAINING = "DRAINING"
STOPPED = "STOPPED"

# Circuit-breaker states.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

#: Bound on joining the timer thread at drain/stop.
_TIMER_JOIN_S = 5.0


class TransientEngineError(RuntimeError):
    """An engine failure known to be environmental (injected chaos, a
    flaky link), not data-dependent: the runtime retries and fails the
    batch without bisecting — no single request is to blame."""


class WallClock:
    """Monotonic wall time; ``sleep`` really sleeps (backoff, drain)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock:
    """A test/drill clock: time only moves when told to.  ``sleep``
    advances instead of blocking, so retry backoff and breaker cooldown
    are instant and exactly reproducible."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"time cannot move backwards ({seconds})")
        self._now += float(seconds)
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.advance(seconds)


class ServeRuntime:
    """Own the serving clock; shed, retry, degrade — never crash.

    engine = ServeEngine(artifact, buckets=(1, 8, 32))     # on cuda
    rt = ServeRuntime(engine, max_pending_samples=256,
                      default_deadline_s=0.05).start()
    h = rt.submit(x)              # x: numpy (P, j) or a tensor
    ...
    rt.drain()                    # graceful shutdown
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        clock=None,
        max_batch: int | None = None,
        max_pending_samples: int | None = None,
        max_pending_requests: int | None = None,
        default_deadline_s: float | None = None,
        flush_interval_s: float | None = None,
        max_retries: int = 2,
        backoff_base_s: float = 0.005,
        backoff_factor: float = 2.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 0.25,
        drain_timeout_s: float = 30.0,
        chaos=None,
        max_events: int = 256,
    ):
        if max_batch is None:
            max_batch = engine.max_batch
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_pending_samples is None:
            max_pending_samples = 8 * max_batch
        if max_pending_requests is None:
            max_pending_requests = max_pending_samples
        if max_pending_samples < max_batch:
            raise ValueError(
                f"max_pending_samples={max_pending_samples} below "
                f"max_batch={max_batch}: no full batch could ever queue"
            )
        if max_retries < 0 or breaker_threshold < 1:
            raise ValueError(
                f"max_retries >= 0 and breaker_threshold >= 1 required, "
                f"got {max_retries}, {breaker_threshold}"
            )
        self.engine = engine
        self.clock = clock if clock is not None else WallClock()
        self.max_batch = int(max_batch)
        self.max_pending_samples = int(max_pending_samples)
        self.max_pending_requests = int(max_pending_requests)
        self.default_deadline_s = default_deadline_s
        self.flush_interval_s = flush_interval_s
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.chaos = chaos

        self._lock = threading.RLock()
        self._queue: list[tuple[np.ndarray, PendingResult]] = []
        self._pending_samples = 0
        self._state = STARTING
        self._breaker = BREAKER_CLOSED
        self._opened_at: float | None = None
        self._consecutive_failures = 0
        self._degraded: set[str] = set()
        self._timer: threading.Thread | None = None
        self._stop_timer = threading.Event()
        self._max_events = int(max_events)
        self.events: list[dict] = []
        self.stats = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "expired": 0,
            "rejected": 0,
            "rejected_overload": 0,
            "rejected_poison": 0,
            "rejected_state": 0,
            "batches": 0,
            "batch_samples": 0,
            "batch_size_hist": {},
            "batch_failures": 0,
            "retries": 0,
            "quarantined": 0,
            "engine_calls": 0,
            "breaker_opens": 0,
            "breaker_closes": 0,
            "reload_ok": 0,
            "reload_failed": 0,
            "max_queue_depth": 0,
        }

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        """Health/lifecycle state.  READY reports as DEGRADED while the
        breaker is non-closed or a degradation (kernels disabled, stale
        weights after a failed reload) is active."""
        with self._lock:
            if self._state == READY and (
                self._breaker != BREAKER_CLOSED or self._degraded
            ):
                return DEGRADED
            return self._state

    @property
    def breaker(self) -> str:
        return self._breaker

    @property
    def degraded_reasons(self) -> tuple[str, ...]:
        return tuple(sorted(self._degraded))

    def _event(self, kind: str, detail: str = "") -> None:
        self.events.append(
            {"t": self.clock.now(), "kind": kind, "detail": detail}
        )
        if len(self.events) > self._max_events:
            del self.events[: len(self.events) - self._max_events]

    def start(self) -> "ServeRuntime":
        """STARTING -> READY; start the timer thread when this runtime
        owns a wall clock and a flush interval was configured."""
        with self._lock:
            if self._state != STARTING:
                raise RuntimeError(f"cannot start from {self._state}")
            self._state = READY
            self._event("lifecycle", "STARTING -> READY")
        if self.flush_interval_s is not None and not isinstance(
            self.clock, ManualClock
        ):
            self._stop_timer.clear()
            self._timer = threading.Thread(
                target=self._timer_loop, name="serve-runtime-timer",
                daemon=True,
            )
            self._timer.start()
        return self

    def _timer_loop(self) -> None:
        while not self._stop_timer.wait(self.flush_interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._event("timer-error", repr(e))

    def _stop_timer_thread(self) -> None:
        self._stop_timer.set()
        timer, self._timer = self._timer, None
        if timer is not None and timer is not threading.current_thread():
            timer.join(timeout=_TIMER_JOIN_S)

    def drain(self) -> int:
        """Graceful shutdown: stop admitting, serve the queue (waiting
        out an open breaker), fail whatever is left when
        ``drain_timeout_s`` runs out, then stop.  Returns the number of
        requests still queued when draining began."""
        with self._lock:
            if self._state == STOPPED:
                return 0
            remaining = len(self._queue)
            self._state = DRAINING
            self._event("lifecycle", "-> DRAINING")
        deadline = self.clock.now() + self.drain_timeout_s
        while True:
            with self._lock:
                if not self._queue:
                    break
                if self.clock.now() >= deadline:
                    self._shed_queue_locked("drain-timeout")
                    break
                self._flush_locked()
                if not self._queue:
                    break
                if self._breaker == BREAKER_OPEN:
                    # Wait out the cooldown so the half-open probe runs.
                    wait = max(
                        0.0,
                        self._opened_at + self.breaker_cooldown_s
                        - self.clock.now(),
                    )
                else:
                    wait = self.backoff_base_s
            self.clock.sleep(min(wait, max(0.0, deadline - self.clock.now())))
            if isinstance(self.clock, ManualClock) and wait == 0.0:
                # A manual clock that cannot move forward would spin.
                self.clock.advance(self.backoff_base_s)
        self._stop_timer_thread()
        with self._lock:
            self._state = STOPPED
            self._event("lifecycle", "DRAINING -> STOPPED")
        return remaining

    def stop(self) -> None:
        """Hard stop: fail everything still queued, no engine calls."""
        self._stop_timer_thread()
        with self._lock:
            if self._state == STOPPED:
                return
            self._shed_queue_locked("runtime stopped")
            self._state = STOPPED
            self._event("lifecycle", "-> STOPPED")

    def _shed_queue_locked(self, reason: str) -> None:
        queue, self._queue = self._queue, []
        self._pending_samples = 0
        for _, handle in queue:
            handle._fail(reason, now=self.clock.now())
            self.stats["failed"] += 1

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return self._pending_samples

    def pending_requests(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, x, *, deadline_s: float | None = None) -> PendingResult:
        """Admit one request (column-stacked ``(P, j)``, or ``(P,)``; a
        numpy array or a tensor, checked on the host).

        Always returns a handle; inadmissible requests come back already
        terminal (``rejected`` with the reason, or ``expired`` for a
        dead-on-arrival deadline) — admission never raises and never
        blocks on the engine."""
        now = self.clock.now()
        handle = PendingResult(0, now=now)
        with self._lock:
            self.stats["submitted"] += 1
            if self._state not in (READY,):
                # DEGRADED still admits (it reports through .state, the
                # stored lifecycle stays READY); anything else sheds.
                self._reject_locked(
                    handle, "state",
                    f"runtime is {self.state}, not accepting requests",
                    now,
                )
                return handle
            try:
                x = self._validate_request(x)
            except ValueError as e:
                self._reject_locked(handle, "poison", str(e), now)
                return handle
            j = x.shape[1]
            handle.num_samples = j
            if deadline_s is None:
                deadline_s = self.default_deadline_s
            if deadline_s is not None:
                if deadline_s <= 0:
                    handle._expire(
                        f"deadline {deadline_s * 1e3:.3f} ms expired at "
                        "admission", now=now,
                    )
                    self.stats["expired"] += 1
                    return handle
                handle.deadline = now + deadline_s
            if (
                len(self._queue) + 1 > self.max_pending_requests
                or self._pending_samples + j > self.max_pending_samples
            ):
                self._reject_locked(
                    handle, "overload",
                    f"overloaded: {len(self._queue)} requests / "
                    f"{self._pending_samples} samples pending (limits "
                    f"{self.max_pending_requests} / "
                    f"{self.max_pending_samples})",
                    now,
                )
                return handle
            self._queue.append((x, handle))
            self._pending_samples += j
            self.stats["max_queue_depth"] = max(
                self.stats["max_queue_depth"], self._pending_samples
            )
            if self._pending_samples >= self.max_batch:
                self._flush_locked()
        return handle

    def _reject_locked(
        self, handle: PendingResult, kind: str, reason: str, now: float
    ) -> None:
        handle._reject(reason, now=now)
        self.stats["rejected"] += 1
        self.stats[f"rejected_{kind}"] += 1
        if kind != "overload":  # overload is routine load shedding
            self._event(f"reject-{kind}", reason)

    def _validate_request(self, x) -> np.ndarray:
        """The request as a host array, checked on the host.  A card
        tensor is copied to the host here, once; that copy waits for the
        card's queue, so callers on a hot path submit host arrays."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()  # numpy has no bfloat16; widening is exact
            x = x.numpy()
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2 or x.shape[1] < 1:
            raise ValueError(
                f"requests are column-stacked (P, j) arrays, got shape "
                f"{tuple(x.shape)}"
            )
        expect = self.engine.request_dim
        if expect is not None and x.shape[0] != expect:
            raise ValueError(
                f"request has {x.shape[0]} feature rows, engine serves "
                f"{expect}"
            )
        if not np.isfinite(x).all():
            raise ValueError(
                "request contains non-finite values (poison rejected at "
                "admission)"
            )
        return x

    # ------------------------------------------------------------------
    # The serving loop
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One timer beat: shed expired requests, honor the breaker
        cooldown, flush the queue.  The wall-clock timer thread calls
        this every ``flush_interval_s``; a manual-clock caller calls it
        explicitly."""
        with self._lock:
            return self._flush_locked()

    def flush(self) -> int:
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if self._state == STOPPED:
            return 0
        self._expire_due_locked()
        if self._breaker == BREAKER_OPEN:
            if (
                self.clock.now() - self._opened_at
                >= self.breaker_cooldown_s
            ):
                self._breaker = BREAKER_HALF_OPEN
                self._event("breaker", "open -> half_open (cooldown over)")
            else:
                return 0  # wait, don't burn the engine
        if not self._queue:
            return 0
        queue, self._queue = self._queue, []
        self._pending_samples = 0
        served = 0
        batches = pack_fifo(queue, self.max_batch)
        for i, batch in enumerate(batches):
            if self._breaker == BREAKER_OPEN:
                # Re-opened mid-flush: requeue the untouched remainder.
                for item in [b for bb in batches[i:] for b in bb]:
                    self._queue.append(item)
                    self._pending_samples += item[0].shape[1]
                break
            self._serve_batch(batch)
            served += len(batch)
        return served

    def _expire_due_locked(self) -> None:
        now = self.clock.now()
        keep = []
        for x, handle in self._queue:
            if handle.deadline is not None and now >= handle.deadline:
                handle._expire(
                    f"deadline missed by {(now - handle.deadline) * 1e3:.3f}"
                    " ms (shed pre-flush)", now=now,
                )
                self.stats["expired"] += 1
                self._pending_samples -= x.shape[1]
            else:
                keep.append((x, handle))
        self._queue = keep

    def _engine_forward(self, xcat: np.ndarray):
        self.stats["engine_calls"] += 1
        if self.chaos is not None:
            self.chaos.on_engine_call(self.clock)
        out = self.engine.forward(xcat)
        # Inside the retry: an asynchronous launch error surfaces here.
        synchronize(self.engine.device)
        return out

    def _serve_batch(self, batch, *, top: bool = True) -> None:
        """Serve one coalesced batch with retry/backoff; on persistent
        failure, bisect data-dependent errors to quarantine the poison
        request, or fail the batch for transient ones.  Only TOP-level
        outcomes feed the circuit breaker — bisection probes of one bad
        request must not open it."""
        xs = [x for x, _ in batch]
        xcat = xs[0] if len(xs) == 1 else np.concatenate(xs, axis=1)
        error: Exception | None = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                self.stats["retries"] += 1
                self.clock.sleep(
                    self.backoff_base_s * self.backoff_factor ** (attempt - 1)
                )
            try:
                out = self._engine_forward(xcat)
            except Exception as e:  # noqa: BLE001 — isolate ANY engine fault
                error = e
                continue
            self.stats["batches"] += 1
            self.stats["batch_samples"] += xcat.shape[1]
            hist = self.stats["batch_size_hist"]
            b = size_bucket(xcat.shape[1])
            hist[b] = hist.get(b, 0) + 1
            scatter_results(batch, out, now=self.clock.now())
            self.stats["completed"] += len(batch)
            self._on_engine_success()
            return

        # Retries exhausted.
        self.stats["batch_failures"] += 1
        if top:
            self._on_batch_failure(error)
        transient = isinstance(error, TransientEngineError)
        if len(batch) == 1 or transient:
            now = self.clock.now()
            for _, handle in batch:
                handle._fail(repr(error), now=now)
                self.stats["failed"] += 1
            if len(batch) == 1 and not transient:
                self.stats["quarantined"] += 1
                self._event(
                    "quarantine",
                    f"poison request isolated after bisect: {error!r}",
                )
            return
        # Data-dependent failure in a multi-request batch: bisect to
        # find the poison request instead of failing its neighbors.
        mid = len(batch) // 2
        self._serve_batch(batch[:mid], top=False)
        self._serve_batch(batch[mid:], top=False)

    # ------------------------------------------------------------------
    # Circuit breaker + degradation
    # ------------------------------------------------------------------
    def _on_engine_success(self) -> None:
        self._consecutive_failures = 0
        if self._breaker == BREAKER_HALF_OPEN:
            self._breaker = BREAKER_CLOSED
            self.stats["breaker_closes"] += 1
            self._event("breaker", "half_open -> closed (probe succeeded)")

    def _on_batch_failure(self, error: Exception | None) -> None:
        if self._breaker == BREAKER_HALF_OPEN:
            self._open_breaker(f"half-open probe failed: {error!r}")
            return
        self._consecutive_failures += 1
        if (
            self._breaker == BREAKER_CLOSED
            and self._consecutive_failures >= self.breaker_threshold
        ):
            self._open_breaker(
                f"{self._consecutive_failures} consecutive batch "
                f"failures (last: {error!r})"
            )

    def _open_breaker(self, reason: str) -> None:
        self._breaker = BREAKER_OPEN
        self._opened_at = self.clock.now()
        self._consecutive_failures = 0
        self.stats["breaker_opens"] += 1
        self._event("breaker", f"-> open: {reason}")
        # ``repro`` degrades here to its einsum route.  The port's route
        # stays the kernel on the card; on the CPU, where both of
        # ``repro``'s routes are the one plain function, the degrade is
        # recorded as ``repro`` records it.
        if (self.engine.device.type == "cpu"
                and "kernels-disabled" not in self._degraded):
            self._degraded.add("kernels-disabled")
            self._event("degrade", "kernel path -> plain version (CPU)")

    # ------------------------------------------------------------------
    # Hot reload under fire
    # ------------------------------------------------------------------
    def reload(self, artifact) -> bool:
        """Hot-swap a newer artifact.  A corrupt / mismatched artifact
        keeps the last-good weights serving (degraded with
        ``stale-weights``), it never takes the runtime down.  Returns
        True on swap, False on keep-last-good."""
        with self._lock:
            try:
                self.engine.reload(artifact)
            except (ArtifactCorruptError, ValueError, OSError) as e:
                self.stats["reload_failed"] += 1
                self._degraded.add("stale-weights")
                self._event("reload-failed", f"keeping last-good: {e}")
                return False
            self.stats["reload_ok"] += 1
            self._degraded.discard("stale-weights")
            self._event("reload-ok", "hot-swapped artifact")
            return True

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-able view of health + counters (the CLI surface)."""
        with self._lock:
            submitted = self.stats["submitted"]
            terminal = (
                self.stats["completed"] + self.stats["failed"]
                + self.stats["rejected"] + self.stats["expired"]
            )
            return {
                "state": self.state,
                "breaker": self._breaker,
                "degraded_reasons": list(self.degraded_reasons),
                "pending_requests": len(self._queue),
                "pending_samples": self._pending_samples,
                "shed_rate": (
                    self.stats["rejected"] / submitted if submitted else 0.0
                ),
                "deadline_hit_rate": (
                    self.stats["expired"] / submitted if submitted else 0.0
                ),
                "terminal": terminal,
                "stats": {
                    k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in self.stats.items()
                },
            }
