"""repro_torch.serve's hardened runtime and chaos drills, on the CPU.

Two groups:

- ``tests/test_serve_runtime.py`` ported onto the port's runtime with
  ``device="cpu"``: clocks, terminal states, bounded admission, poison,
  deadlines, retry and backoff, bisection quarantine, the circuit
  breaker, reload under fire, drain, the timer
  thread raced by submitters (bounded joins) and the seeded chaos drill,
  whose ``mesh`` leg serves a stack trained under a one-rank
  ``MeshBackend``.
- Parity with ``repro``: the same requests on the same ``ManualClock``
  schedule through both packages' runtimes give the same stats, event
  kinds, per-handle statuses and reasons and injected fault counts, and
  completed logits within rtol/atol 1e-5 (both sum in f32 through
  different GEMMs, the bar of ``tests/test_torch_serve.py``); the same
  ``parse_chaos`` specs parse alike and refuse with the same messages;
  the launcher's ``--runtime --manual-clock --chaos`` run gives the same
  terminal counts and stats.

Virtual time moves only by the drills' own advances, the chaos sleeps
and the backoff, so each drill's counts depend on its schedule alone,
not on the stack's width or the device.
"""
import os
import re
import shutil
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro import dssfn as jdssfn
from repro.analysis import synthetic_serve_engine
from repro.core import ssfn as jssfn
from repro.launch import serve_dssfn as jlaunch
from repro_torch import dssfn as tdssfn
from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn as tssfn
from repro_torch.launch import serve_dssfn as tlaunch
from repro_torch.serve import (
    ChaosInjector,
    ManualClock,
    MicroBatcher,
    PendingResult,
    RequestError,
    ServeArtifact,
    ServeEngine,
    ServeRuntime,
    TransientEngineError,
    WallClock,
    corrupt_artifact,
    export_artifact,
    load_artifact,
    parse_chaos,
)

P = 6          # synthetic engine input dim
Q = 4          # synthetic engine classes
TOL = dict(rtol=1e-5, atol=1e-5)
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src", "repro_torch")

#: The seeded drill of ``tests/test_serve_runtime.py::test_chaos_drill_end_to_end``.
DRILL_CHAOS = "fail=0.25:burst=4:seed=7"
DRILL_RUNTIME = dict(
    max_batch=32, max_pending_samples=32, default_deadline_s=0.02,
    max_retries=1, backoff_base_s=1e-3, breaker_threshold=2,
    breaker_cooldown_s=0.05, drain_timeout_s=10.0,
)
#: What that drill gives through ``repro`` on the CPU; ``chip_smoke.py``
#: phase 4b holds the card's run to the port's own CPU run of it.
DRILL_STATS = dict(
    completed=118, failed=50, expired=160, rejected=72, rejected_overload=56,
    rejected_poison=16, batches=18, engine_calls=32, retries=7,
    breaker_opens=4, breaker_closes=2, max_queue_depth=32,
)


def _synthetic_stack(seed=0, q=Q, p=P, layers=2, extra=8):
    """``repro.analysis.synthetic_serve_engine``'s numbers: O_0 (Q, P),
    R_l (extra, fan_in), O_l (Q, n) with n = 2Q + extra."""
    rng = np.random.default_rng(seed)
    n = 2 * q + extra
    o = [rng.standard_normal((q, p))]
    r = []
    fan_in = p
    for _ in range(layers):
        r.append(rng.standard_normal((extra, fan_in)))
        fan_in = n
        o.append(rng.standard_normal((q, n)))
    return o, r


def _artifact(o, r, q=Q):
    return ServeArtifact(
        params=params_from_numpy(o, r, device="cpu"), num_classes=q,
        input_dim=o[0].shape[1], activation="relu", features=None, version=1,
        manifest={"source": "tests synthetic"},
    )


def _engine(seed=0, **kw):
    kw.setdefault("buckets", (1, 4, 8))
    return ServeEngine(_artifact(*_synthetic_stack(seed)), device="cpu", **kw)


def _runtime(engine=None, **kw):
    engine = engine or _engine()
    kw.setdefault("clock", ManualClock())
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_pending_samples", 64)
    kw.setdefault("backoff_base_s", 1e-3)
    kw.setdefault("drain_timeout_s", 10.0)
    return ServeRuntime(engine, **kw).start()


def _req(rng, j=1):
    return rng.standard_normal((P, j)).astype(np.float32)


class WrappedEngine:
    """Delegate-everything engine wrapper; subclasses override forward."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def forward(self, x):
        return self._engine.forward(x)


class FlakyEngine(WrappedEngine):
    """Fails the first ``fail_times`` forwards with a TRANSIENT error."""

    def __init__(self, engine, fail_times, error=TransientEngineError):
        super().__init__(engine)
        self.fail_times = fail_times
        self.error = error
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.error("injected transient fault")
        return self._engine.forward(x)


class TrapEngine(WrappedEngine):
    """Raises a DATA-DEPENDENT error whenever a trap column (x[0] ==
    TRAP) is present: the poison-bisection target."""

    TRAP = 777.0

    def __init__(self, engine):
        super().__init__(engine)
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        if np.any(np.asarray(x)[0] == self.TRAP):
            raise ValueError("trap column in batch")
        return self._engine.forward(x)


class DeadEngine(WrappedEngine):
    """Every forward fails transiently until ``revive()`` is called."""

    def __init__(self, engine, error=TransientEngineError):
        super().__init__(engine)
        self.dead = True
        self.error = error
        self.calls = 0

    def revive(self):
        self.dead = False

    def forward(self, x):
        self.calls += 1
        if self.dead:
            raise self.error("engine down")
        return self._engine.forward(x)


def _trap():
    x = np.zeros((P, 1), np.float32)
    x[0, 0] = TrapEngine.TRAP
    return x


# ---------------------------------------------------------------------------
# Clocks + PendingResult terminal states
# ---------------------------------------------------------------------------


def test_manual_clock():
    clock = ManualClock()
    assert clock.now() == 0.0
    clock.advance(1.5)
    clock.sleep(0.5)                 # sleep advances instead of blocking
    assert clock.now() == 2.0
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)


def test_wall_clock_monotonic():
    clock = WallClock()
    a = clock.now()
    clock.sleep(0.0)                 # no-op, must not raise
    assert clock.now() >= a


def test_pending_result_terminal_states():
    h = PendingResult(1, now=10.0)
    assert not h.done() and not h.ok()
    with pytest.raises(RuntimeError, match="not served"):
        h.result()
    h._fail("engine exploded", now=12.5)
    assert h.done() and not h.ok() and h.status == "failed"
    assert h.latency_s == 2.5
    with pytest.raises(RequestError, match="failed: engine exploded"):
        h.result()
    with pytest.raises(RuntimeError, match="already terminal"):
        h._complete(torch.zeros((2, 1)))

    for method, status in (("_reject", "rejected"), ("_expire", "expired")):
        h2 = PendingResult(1, now=0.0)
        getattr(h2, method)("why", now=1.0)
        assert h2.status == status and h2.error == "why"
        with pytest.raises(RequestError, match=status):
            h2.result()


# ---------------------------------------------------------------------------
# Batcher stats: bounded, not a per-batch list
# ---------------------------------------------------------------------------


def test_batcher_stats_bounded():
    engine = _engine()
    batcher = MicroBatcher(engine, max_batch=4, max_wait_us=1e9)
    rng = np.random.default_rng(0)
    for _ in range(64):
        batcher.submit(_req(rng))
    batcher.flush()
    assert "batch_sizes" not in batcher.stats
    assert batcher.stats["batches"] == 16
    assert batcher.stats["batch_samples"] == 64
    assert batcher.stats["batch_size_hist"] == {4: 16}
    assert batcher.mean_batch_size() == 4.0
    snap = dict(batcher.stats)
    batcher.submit(_req(rng, 2))
    batcher.flush()
    assert batcher.mean_batch_size(since=snap) == 2.0


# ---------------------------------------------------------------------------
# Admission: overload, poison, lifecycle
# ---------------------------------------------------------------------------


def test_submit_completes_bit_exact_vs_direct_forward():
    # One bucket: the coalesced serve and the direct forward run the
    # same padded program, so they agree bit for bit.
    engine = _engine(buckets=(8,))
    rt = _runtime(engine)
    rng = np.random.default_rng(1)
    xs = [_req(rng, j) for j in (1, 3, 2)]
    handles = [rt.submit(x) for x in xs]
    rt.flush()
    for x, h in zip(xs, handles):
        assert h.ok()
        assert torch.equal(h.result(), engine.forward(x))


def test_overload_rejected_with_reason():
    rt = _runtime(max_batch=8, max_pending_samples=8, max_pending_requests=2)
    rng = np.random.default_rng(0)
    h1, h2 = rt.submit(_req(rng)), rt.submit(_req(rng))
    h3 = rt.submit(_req(rng))                  # 3rd queued request: shed
    assert not h1.done() and not h2.done()
    assert h3.status == "rejected" and "overloaded" in h3.error
    assert rt.stats["rejected_overload"] == 1
    h4 = rt.submit(_req(rng, 7))               # the sample bound
    assert h4.status == "rejected" and "overloaded" in h4.error
    rt.flush()
    assert h1.ok() and h2.ok()


def test_poison_rejected_at_admission():
    engine = _engine()
    rt = _runtime(engine)
    bad_nan = np.zeros((P, 1), np.float32)
    bad_nan[0, 0] = np.nan
    h = rt.submit(bad_nan)
    assert h.status == "rejected" and "non-finite" in h.error
    h = rt.submit(np.zeros((P + 1, 2), np.float32))
    assert h.status == "rejected" and "feature rows" in h.error
    h = rt.submit(np.zeros((P, 1, 1), np.float32))
    assert h.status == "rejected" and "column-stacked" in h.error
    assert rt.stats["rejected_poison"] == 3
    assert rt.stats["engine_calls"] == 0       # poison never reaches it


def test_lifecycle_gates_admission():
    rt = _runtime()
    with pytest.raises(RuntimeError, match="cannot start"):
        rt.start()
    rt.drain()
    assert rt.state == "STOPPED"
    h = rt.submit(np.zeros((P, 1), np.float32))
    assert h.status == "rejected" and "STOPPED" in h.error
    assert rt.stats["rejected_state"] == 1


def test_stop_fails_pending():
    rt = _runtime(max_batch=8)
    h = rt.submit(np.zeros((P, 1), np.float32))
    rt.stop()
    assert h.status == "failed" and "stopped" in h.error
    assert rt.state == "STOPPED"


def test_host_arrays_and_tensors_admitted():
    """Requests are checked on the host: numpy arrays and tensors (bf16
    widened exactly) are served alike, and none counts as poison (a
    card tensor is copied to the host once:
    ``tests/test_torch_runtime_cuda.py``)."""
    engine = _engine(buckets=(8,))
    rt = _runtime(engine)
    x = np.random.default_rng(2).standard_normal((P, 2)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    h_np, h_t, h_b = rt.submit(x), rt.submit(torch.from_numpy(x)), rt.submit(xb)
    rt.flush()
    assert torch.equal(h_np.result(), h_t.result())
    assert torch.equal(h_b.result(), engine.forward(xb.float()))
    assert rt.stats["rejected_poison"] == 0 and rt.stats["completed"] == 3


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def test_deadline_expired_at_admission():
    rt = _runtime()
    h = rt.submit(np.zeros((P, 1), np.float32), deadline_s=0.0)
    assert h.status == "expired" and "at admission" in h.error


def test_deadline_shed_pre_flush_never_served():
    clock = ManualClock()
    rt = _runtime(clock=clock, max_batch=8, default_deadline_s=0.01)
    h_dead = rt.submit(np.zeros((P, 1), np.float32))
    clock.advance(0.02)
    h_live = rt.submit(np.ones((P, 1), np.float32))
    rt.tick()
    assert h_dead.status == "expired" and "pre-flush" in h_dead.error
    assert h_live.ok()
    assert rt.stats["engine_calls"] == 1
    assert rt.stats["expired"] == 1
    assert rt.snapshot()["deadline_hit_rate"] == 0.5


def test_per_request_deadline_overrides_default():
    clock = ManualClock()
    rt = _runtime(clock=clock, default_deadline_s=1.0)
    h = rt.submit(np.zeros((P, 1), np.float32), deadline_s=0.005)
    clock.advance(0.01)
    rt.tick()
    assert h.status == "expired"


# ---------------------------------------------------------------------------
# Retry, bisect quarantine, circuit breaker
# ---------------------------------------------------------------------------


def test_transient_fault_retries_with_backoff():
    engine = FlakyEngine(_engine(), fail_times=2)
    clock = ManualClock()
    rt = _runtime(
        engine, clock=clock, max_retries=2,
        backoff_base_s=0.001, backoff_factor=2.0,
    )
    h = rt.submit(np.zeros((P, 1), np.float32))
    t0 = clock.now()
    rt.flush()
    assert h.ok()
    assert engine.calls == 3
    assert rt.stats["retries"] == 2
    assert clock.now() - t0 == pytest.approx(0.001 + 0.002)


def test_transient_exhaustion_fails_batch_without_bisect():
    engine = FlakyEngine(_engine(), fail_times=100)
    rt = _runtime(engine, max_retries=1, breaker_threshold=10)
    handles = [rt.submit(np.zeros((P, 1), np.float32)) for _ in range(4)]
    rt.flush()
    assert all(h.status == "failed" for h in handles)
    assert engine.calls == 2                    # one batch, two attempts
    assert rt.stats["quarantined"] == 0


def test_bisect_quarantines_poison_neighbors_complete():
    inner = _engine(buckets=(8,))
    engine = TrapEngine(inner)
    rt = _runtime(engine, max_retries=0, breaker_threshold=10, max_batch=8)
    rng = np.random.default_rng(3)
    xs = [_req(rng) for _ in range(5)]
    xs.insert(2, _trap())
    handles = [rt.submit(x) for x in xs]
    rt.flush()
    statuses = [h.status for h in handles]
    assert statuses.count("failed") == 1 and statuses[2] == "failed"
    assert "trap column" in handles[2].error
    assert rt.stats["quarantined"] == 1
    for i, (x, h) in enumerate(zip(xs, handles)):
        if i == 2:
            continue
        assert h.ok()
        assert torch.equal(h.result(), inner.forward(x))
    # bisection probes are not top-level failures: the breaker stays shut
    assert rt.breaker == "closed"
    assert rt.stats["breaker_opens"] == 0


def test_breaker_opens_blocks_engine_then_recloses():
    engine = DeadEngine(_engine())
    clock = ManualClock()
    rt = _runtime(
        engine, clock=clock, max_retries=0,
        breaker_threshold=2, breaker_cooldown_s=0.1, max_batch=8,
    )
    dead = []
    for _ in range(2):
        dead.append(rt.submit(np.zeros((P, 1), np.float32)))
        rt.flush()
    assert all(h.status == "failed" for h in dead)
    assert rt.breaker == "open" and rt.state == "DEGRADED"
    assert rt.stats["breaker_opens"] == 1

    calls = engine.calls
    h_wait = rt.submit(np.zeros((P, 1), np.float32))
    rt.flush()
    assert engine.calls == calls and not h_wait.done()

    clock.advance(0.11)
    rt.tick()
    assert rt.breaker == "open"
    assert rt.stats["breaker_opens"] == 2
    assert h_wait.status == "failed"

    engine.revive()
    h_ok = rt.submit(np.ones((P, 1), np.float32))
    clock.advance(0.11)
    rt.tick()
    assert h_ok.ok()
    assert rt.breaker == "closed"
    assert rt.stats["breaker_closes"] == 1
    # on the CPU the degrade stays recorded, as in ``repro``
    assert rt.state == "DEGRADED" and "kernels-disabled" in rt.degraded_reasons


def test_breaker_open_degrades_kernel_path():
    """On the CPU the first open records ``repro``'s degrade (both of its
    routes are the plain version there)."""
    engine = DeadEngine(_engine())
    rt = _runtime(engine, max_retries=0, breaker_threshold=1)
    h = rt.submit(np.zeros((P, 1), np.float32))
    rt.flush()
    assert h.status == "failed"
    assert rt.breaker == "open"
    assert "kernels-disabled" in rt.degraded_reasons
    assert rt.state == "DEGRADED"
    assert [e["kind"] for e in rt.events][-2:] == ["breaker", "degrade"]
    assert rt.snapshot()["degraded_reasons"] == ["kernels-disabled"]


def test_engine_success_resets_consecutive_failures():
    engine = TrapEngine(_engine())
    rt = _runtime(engine, max_retries=0, breaker_threshold=2, max_batch=1)
    for _ in range(3):                          # fail, succeed, fail, ...
        assert rt.submit(_trap()).status == "failed"
        assert rt.submit(np.ones((P, 1), np.float32)).ok()
    assert rt.breaker == "closed"


# ---------------------------------------------------------------------------
# The engine's route: no switch
# ---------------------------------------------------------------------------


class CardEngine(DeadEngine):
    """A dead engine that reports a device other than the CPU (``meta``
    stands in for the card; synchronizing it is a no-op)."""

    device = torch.device("meta")


def test_engine_has_no_route_switch():
    """The engine takes no ``use_kernels``: on the card its route is the
    kernel, and nothing can turn it off."""
    engine = _engine()
    assert not hasattr(engine, "use_kernels")
    assert "use_kernels" not in engine.describe()
    with pytest.raises(TypeError, match="use_kernels"):
        _engine(use_kernels=False)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_route_matches_reference_on_cpu(use_kernels):
    """On the CPU the engine is the plain version: bit-equal to
    ``ssfn.predict`` and within 1e-5 of ``repro``'s engine on either of
    its routes."""
    x = np.random.default_rng(4).standard_normal((P, 5)).astype(np.float32)
    engine = _engine(buckets=(5,))
    got = engine.forward(x)
    assert torch.equal(got, tssfn.predict(engine.artifact.params, torch.from_numpy(x), Q))
    ref = synthetic_serve_engine(buckets=(1, 4, 8), use_kernels=use_kernels).forward(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_breaker_keeps_the_card_route():
    """Off the CPU the breaker only holds the engine off for its
    cooldown: no degrade event, no ``kernels-disabled``, every later
    batch through the same ``engine.forward``, and READY once the
    breaker closes."""
    engine = CardEngine(_engine())
    clock = ManualClock()
    rt = _runtime(engine, clock=clock, max_retries=0, breaker_threshold=1,
                  breaker_cooldown_s=0.1)
    dead = rt.submit(np.zeros((P, 1), np.float32))
    rt.flush()
    assert dead.status == "failed"
    assert rt.breaker == "open" and rt.state == "DEGRADED"
    assert rt.degraded_reasons == ()
    assert "degrade" not in _event_kinds(rt)
    engine.revive()
    calls = engine.calls
    h = rt.submit(np.ones((P, 1), np.float32))
    clock.advance(0.11)
    rt.tick()
    assert h.ok() and engine.calls == calls + 1
    assert torch.equal(h.result(), engine._engine.forward(np.ones((P, 1), np.float32)))
    assert rt.breaker == "closed" and rt.state == "READY"
    assert rt.snapshot()["degraded_reasons"] == []


def test_no_port_code_switches_the_route():
    """No module of the port names a kernel switch, and the serving
    package never calls the plain version in place of the kernel."""
    for d, _, fs in os.walk(PORT):
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    src = fh.read()
                assert not re.search(r"\buse_kernels\s*=", src), f
                if os.path.basename(d) == "serve":
                    assert "matmul_relu_ref" not in src, f


# ---------------------------------------------------------------------------
# Reload under fire
# ---------------------------------------------------------------------------


def _train_reference(workers=4, samples=16):
    key = jax.random.PRNGKey(0)
    kx, kt = jax.random.split(key)
    xw = jax.random.normal(kx, (workers, 8, samples))
    labels = jax.random.randint(kt, (workers, samples), 0, 3)
    tw = jax.nn.one_hot(labels, 3).transpose(0, 2, 1)
    cfg = jssfn.SSFNConfig(
        input_dim=8, num_classes=3, num_layers=2, hidden=20, admm_iters=30
    )
    return jdssfn.train(
        jdssfn.TrainSpec(cfg=cfg, backend="simulated", workers=workers),
        xw, tw, jax.random.PRNGKey(1),
    )


@pytest.fixture(scope="module")
def trained_artifact(tmp_path_factory):
    """A stack ``repro`` trained (M=4, 2 layers of 20), exported by
    ``repro`` and loaded by the port."""
    path = str(tmp_path_factory.mktemp("truntime") / "stack")
    jserve.export_artifact(path, _train_reference())
    return path, load_artifact(path)


def test_reload_corrupt_keeps_last_good_bit_exact(trained_artifact, tmp_path):
    path, art = trained_artifact
    engine = ServeEngine(path, buckets=(4,), device="cpu")
    rt = _runtime(engine, max_batch=4)
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (8, 4)), np.float32)
    ref = tssfn.predict(art.params, torch.from_numpy(x), 3)

    h0 = rt.submit(x)
    assert torch.equal(h0.result(), ref)

    bad = str(tmp_path / "bad")
    shutil.copytree(path, bad)
    corrupt_artifact(bad)
    assert rt.reload(bad) is False
    assert rt.stats["reload_failed"] == 1
    assert "stale-weights" in rt.degraded_reasons
    assert rt.state == "DEGRADED"
    h1 = rt.submit(x)
    assert torch.equal(h1.result(), ref)

    assert rt.reload(path) is True
    assert rt.state == "READY"
    h2 = rt.submit(x)
    assert torch.equal(h2.result(), ref)


def test_reload_shape_mismatch_keeps_serving(trained_artifact):
    path, _ = trained_artifact
    engine = ServeEngine(path, buckets=(1,), device="cpu")
    rt = _runtime(engine, max_batch=1)
    other = _engine()
    assert rt.reload(other.artifact) is False
    assert rt.state == "DEGRADED"
    assert rt.submit(np.zeros((8, 1), np.float32)).ok()


# ---------------------------------------------------------------------------
# Drain + timer-thread safety
# ---------------------------------------------------------------------------


def test_drain_serves_queue_then_stops():
    rt = _runtime(max_batch=8)
    rng = np.random.default_rng(0)
    handles = [rt.submit(_req(rng)) for _ in range(5)]
    assert rt.pending() == 5
    assert rt.drain() == 5
    assert all(h.ok() for h in handles)
    assert rt.pending() == 0 and rt.state == "STOPPED"
    assert rt.drain() == 0


def test_drain_timeout_fails_leftovers():
    engine = DeadEngine(_engine())
    clock = ManualClock()
    rt = _runtime(
        engine, clock=clock, max_retries=0, breaker_threshold=1,
        breaker_cooldown_s=0.05, drain_timeout_s=0.5, max_batch=8,
    )
    h = rt.submit(np.zeros((P, 1), np.float32))
    rt.drain()
    assert h.done()
    assert rt.state == "STOPPED"
    assert clock.now() <= 1.0


def test_timer_thread_vs_concurrent_submits():
    """submit() from four threads racing the wall-clock timer's flush,
    with a short switch interval: no lost update, every handle completed
    and right, every thread joined within its bound."""
    engine = _engine(buckets=(8,))
    rt = ServeRuntime(
        engine, max_batch=8, max_pending_samples=4096,
        max_pending_requests=4096, flush_interval_s=0.001,
    ).start()
    timer = rt._timer
    assert timer is not None and timer.is_alive()
    rng = np.random.default_rng(0)
    xs = [_req(rng) for _ in range(200)]
    handles = [None] * len(xs)

    def worker(idxs):
        for i in idxs:
            handles[i] = rt.submit(xs[i])

    threads = [
        threading.Thread(target=worker, args=(range(k, len(xs), 4),))
        for k in range(4)
    ]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rt.drain()
    assert rt._timer is None and not timer.is_alive()   # joined on drain
    assert all(h is not None and h.ok() for h in handles)
    assert rt.stats["completed"] == len(xs)
    assert rt.stats["submitted"] == len(xs)
    assert rt.stats["batch_samples"] == len(xs)
    for x, h in zip(xs, handles):
        assert torch.equal(h.result(), engine.forward(x))


# ---------------------------------------------------------------------------
# The full chaos drill
# ---------------------------------------------------------------------------


def _chaos_drill(serve, engine, *, rows=8, requests=400):
    """The seeded drill through ``serve`` (either package's module):
    engine faults, poison every 25th request, overload beyond a 32-sample
    bound, 0.5 ms of virtual time a request and a tick every 4."""
    clock = serve.ManualClock()
    chaos = serve.parse_chaos(DRILL_CHAOS)
    rt = serve.ServeRuntime(engine, clock=clock, chaos=chaos, **DRILL_RUNTIME).start()
    rng = np.random.default_rng(11)
    entries = []
    for i in range(requests):
        x = rng.standard_normal((rows, 1)).astype(np.float32)
        if i % 25 == 12:
            x = x.copy()
            x[0, 0] = np.nan
        entries.append((x, rt.submit(x)))
        clock.advance(5e-4)
        if (i + 1) % 4 == 0:
            rt.tick()
    rt.drain()
    return rt, chaos, entries


def test_chaos_drill_end_to_end(trained_artifact):
    """Seeded engine faults + poison + overload: every handle terminal,
    healthy results bit-identical to an unbatched forward, the breaker
    open AND re-closed, a clean drain."""
    path, art = trained_artifact
    engine = ServeEngine(path, buckets=(32,), device="cpu")
    rt, chaos, entries = _chaos_drill(tserve, engine)

    assert all(h.done() for _, h in entries)
    snap = rt.snapshot()
    assert snap["state"] == "STOPPED"
    assert snap["pending_requests"] == 0
    s = snap["stats"]
    assert s["breaker_opens"] >= 1 and s["breaker_closes"] >= 1
    assert s["rejected_poison"] == 16
    assert s["rejected_overload"] > 0
    assert s["expired"] > 0
    assert s["completed"] > 0
    assert s["max_queue_depth"] <= 32
    assert chaos.injected_failures > 0
    assert "kernels-disabled" in snap["degraded_reasons"]

    n_checked = 0
    for x, h in entries:
        if h.ok():
            assert torch.equal(h.result(), engine.forward(x))
            n_checked += 1
    assert n_checked == s["completed"] > 0
    healthy = [x for x, _ in entries if np.isfinite(x).all()]
    xfull = torch.from_numpy(np.concatenate(healthy[:32], axis=1))
    assert torch.equal(engine.forward(xfull), tssfn.predict(art.params, xfull, 3))


def test_chaos_drill_mesh_leg_waits_for_item_5(tmp_path):
    """The drill's mesh leg (``tests/test_serve_runtime.py:571-600``): a
    stack trained under a one-rank ``MeshBackend`` (one worker of 64
    samples, as ``repro``'s ``MeshBackend(make_worker_mesh(1))``), within
    1e-4 of ``repro``'s mesh-trained stack, exported and drilled: the
    seeded drill's counts, every handle terminal, every completed result
    bit-equal to its own forward."""
    from repro.core.backend import MeshBackend as JMeshBackend
    from repro.launch.mesh import make_worker_mesh
    from repro_torch import prng
    from repro_torch.core.backend import MeshBackend
    from repro_torch.launch.mesh import make_worker_group

    kw = dict(input_dim=8, num_classes=3, num_layers=2, hidden=20, admm_iters=30)
    rng = np.random.default_rng(0)
    xw = rng.standard_normal((1, 8, 64)).astype(np.float32)
    tw = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, 64))].transpose(0, 2, 1).copy()
    spec = tdssfn.TrainSpec(cfg=tssfn.SSFNConfig(**kw),
                            backend=MeshBackend(make_worker_group(1, device="cpu")))
    result = tdssfn.train(spec, torch.from_numpy(xw), torch.from_numpy(tw),
                          key=prng.PRNGKey(1))
    jspec = jdssfn.TrainSpec(cfg=jssfn.SSFNConfig(**kw), backend=JMeshBackend(make_worker_mesh(1)))
    jresult = jdssfn.train(jspec, xw, tw, jax.random.PRNGKey(1))
    for a, b in zip(result.params.o, jresult.params.o):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.numpy() - b) <= 1e-4 * np.linalg.norm(b)
    path = str(tmp_path / "mesh_stack")
    export_artifact(path, result)
    engine = ServeEngine(path, buckets=(32,), device="cpu")
    rt, chaos, entries = _chaos_drill(tserve, engine)
    assert all(h.done() for _, h in entries)
    assert {k: rt.stats[k] for k in DRILL_STATS} == DRILL_STATS
    assert chaos.injected_failures > 0
    done = [(x, h) for x, h in entries if h.ok()]
    assert len(done) == DRILL_STATS["completed"]
    for x, h in done:
        assert torch.equal(h.result(), engine.forward(x))


def test_chaos_injector_deterministic():
    a, b = ChaosInjector(seed=3, engine_fail=0.5), ChaosInjector(seed=3, engine_fail=0.5)
    clock = ManualClock()
    outcomes = []
    for inj in (a, b):
        seq = []
        for _ in range(50):
            try:
                inj.on_engine_call(clock)
                seq.append(0)
            except TransientEngineError:
                seq.append(1)
        outcomes.append(seq)
    assert outcomes[0] == outcomes[1]
    assert sum(outcomes[0]) > 0


def test_parse_chaos_spec():
    c = parse_chaos("fail=0.2:burst=3:spike=0.1:spike_s=0.02:seed=9")
    assert c.engine_fail == 0.2 and c.fail_burst == 3
    assert c.latency_spike == 0.1 and c.spike_s == 0.02 and c.seed == 9
    with pytest.raises(ValueError, match="unknown chaos key"):
        parse_chaos("frequency=9")
    with pytest.raises(ValueError, match="key=value"):
        parse_chaos("fail")


# ---------------------------------------------------------------------------
# Parity with repro
# ---------------------------------------------------------------------------


def _event_kinds(rt):
    return [e["kind"] for e in rt.events]


def _terminal(entries):
    return [(h.status, h.error) for _, h in entries]


def _assert_same_run(t_rt, j_rt, t_entries, j_entries):
    assert t_rt.snapshot()["stats"] == j_rt.snapshot()["stats"]
    assert _event_kinds(t_rt) == _event_kinds(j_rt)
    assert [e["t"] for e in t_rt.events] == [e["t"] for e in j_rt.events]
    assert _terminal(t_entries) == _terminal(j_entries)
    assert t_rt.state == j_rt.state
    assert t_rt.breaker == j_rt.breaker
    for (_, th), (_, jh) in zip(t_entries, j_entries):
        assert th.submitted_at == jh.submitted_at
        assert th.completed_at == jh.completed_at
        if th.ok():
            np.testing.assert_allclose(
                th.result().numpy(), np.asarray(jh.result()), **TOL
            )


def test_seeded_chaos_drill_matches_reference(trained_artifact):
    path, _ = trained_artifact
    t_engine = ServeEngine(path, buckets=(32,), device="cpu")
    j_engine = jserve.ServeEngine(path, buckets=(32,), use_kernels=True)
    t_rt, t_chaos, t_entries = _chaos_drill(tserve, t_engine)
    j_rt, j_chaos, j_entries = _chaos_drill(jserve, j_engine)

    _assert_same_run(t_rt, j_rt, t_entries, j_entries)
    for name in ("injected_failures", "injected_spikes", "injected_skews"):
        assert getattr(t_chaos, name) == getattr(j_chaos, name)
    assert t_rt.degraded_reasons == j_rt.degraded_reasons == ("kernels-disabled",)
    assert j_engine.use_kernels is False
    stats = t_rt.snapshot()["stats"]
    assert {k: stats[k] for k in DRILL_STATS} == DRILL_STATS
    assert len(t_rt.events) == 30


def _scenario_overload(serve, engine, rng):
    rt = serve.ServeRuntime(engine, clock=serve.ManualClock(), max_batch=8,
                            max_pending_samples=8, max_pending_requests=3).start()
    xs = [_req(rng, 1 + i % 3) for i in range(40)]
    entries = []
    for i, x in enumerate(xs):
        entries.append((x, rt.submit(x)))
        if i % 5 == 4:
            rt.tick()
    rt.drain()
    return rt, entries


def _scenario_deadlines(serve, engine, rng):
    clock = serve.ManualClock()
    rt = serve.ServeRuntime(engine, clock=clock, max_batch=8, default_deadline_s=0.004,
                            max_pending_samples=64).start()
    entries = []
    for i in range(48):
        deadline = {0: None, 1: 0.0, 2: 0.010}[i % 3]
        x = _req(rng)
        entries.append((x, rt.submit(x, deadline_s=deadline)))
        clock.advance(1e-3 * (1 + i % 4))
        if i % 6 == 5:
            rt.tick()
    rt.drain()
    return rt, entries


def _scenario_poison(serve, engine, rng):
    trapped = TrapEngine(engine)
    rt = serve.ServeRuntime(trapped, clock=serve.ManualClock(), max_batch=8, max_retries=1,
                            backoff_base_s=1e-3, breaker_threshold=3,
                            max_pending_samples=64).start()
    entries = []
    for i in range(40):
        x = _trap() if i % 7 == 3 else _req(rng)
        entries.append((x, rt.submit(x)))
    rt.drain()
    return rt, entries


def _scenario_burst(serve, engine, rng):
    clock = serve.ManualClock()
    dead = DeadEngine(engine, error=serve.TransientEngineError)
    rt = serve.ServeRuntime(dead, clock=clock, max_batch=4, max_retries=1,
                            backoff_base_s=1e-3, breaker_threshold=2,
                            breaker_cooldown_s=0.02, max_pending_samples=64).start()
    entries = []
    for i in range(30):
        if i == 14:
            dead.revive()
        x = _req(rng)
        entries.append((x, rt.submit(x)))
        clock.advance(4e-3)
        rt.tick()
    rt.drain()
    assert rt.stats["breaker_opens"] >= 1 and rt.stats["breaker_closes"] == 1
    return rt, entries


def _scenario_reload(serve, engine, rng, *, good, bad):
    rt = serve.ServeRuntime(engine, clock=serve.ManualClock(), max_batch=4,
                            max_pending_samples=64).start()
    entries = []
    for step in range(3):
        x = rng.standard_normal((8, 4)).astype(np.float32)
        entries.append((x, rt.submit(x)))
        if step == 0:
            assert rt.reload(bad) is False
        elif step == 1:
            assert rt.reload(good) is True
    rt.drain()
    return rt, entries


SCENARIOS = {
    "overload": _scenario_overload,
    "deadlines": _scenario_deadlines,
    "poison-bisection": _scenario_poison,
    "transient-burst": _scenario_burst,
    "corrupt-reload": _scenario_reload,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_drill_matches_reference(name, trained_artifact, tmp_path):
    """Each drill that reproduces a fault gives both packages the same
    stats, events, statuses and reasons, and results within 1e-5."""
    scenario = SCENARIOS[name]
    runs = []
    for serve in (tserve, jserve):
        if name == "corrupt-reload":
            path, _ = trained_artifact
            bad = str(tmp_path / f"bad_{serve.__name__}")
            shutil.copytree(path, bad)
            serve.corrupt_artifact(bad)
            kw = {"device": "cpu"} if serve is tserve else {}
            engine = serve.ServeEngine(path, buckets=(4,), **kw)
            runs.append(scenario(serve, engine, np.random.default_rng(0), good=path, bad=bad))
        else:
            engine = (_engine(buckets=(8,)) if serve is tserve
                      else synthetic_serve_engine(buckets=(8,), use_kernels=True))
            runs.append(scenario(serve, engine, np.random.default_rng(0)))
    (t_rt, t_entries), (j_rt, j_entries) = runs
    _assert_same_run(t_rt, j_rt, t_entries, j_entries)
    assert t_rt.degraded_reasons == j_rt.degraded_reasons


CHAOS_SPECS = [
    "",
    "fail=0.2",
    "burst=3",
    "spike=0.1",
    "spike_s=0.02",
    "skew=0.3",
    "skew_s=0.5",
    "seed=9",
    "fail=0.2:burst=3:spike=0.1:spike_s=0.02:skew=0.3:skew_s=0.5:seed=9",
    " fail=0.5 : : seed=1 ",
]
BAD_CHAOS_SPECS = [
    "fail",
    "frequency=9",
    "fail=1.5",
    "spike=-0.1",
    "burst=0",
    "burst=two",
    "seed=1:skew",
]


def _chaos_fields(c):
    return (c.seed, c.engine_fail, c.fail_burst, c.latency_spike, c.spike_s,
            c.clock_skew, c.skew_s, c.describe())


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_parse_chaos_matches_reference(spec):
    assert _chaos_fields(parse_chaos(spec)) == _chaos_fields(jserve.parse_chaos(spec))


@pytest.mark.parametrize("spec", BAD_CHAOS_SPECS)
def test_parse_chaos_refuses_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jserve.parse_chaos(spec)
    with pytest.raises(ValueError) as got:
        parse_chaos(spec)
    assert str(got.value) == str(want.value)


def test_chaos_schedule_matches_reference():
    """Spikes, skews and bursts draw in ``repro``'s order: the same seed
    gives the same faults at the same virtual times."""
    runs = []
    for serve in (tserve, jserve):
        clock = serve.ManualClock()
        inj = serve.ChaosInjector(seed=5, engine_fail=0.3, fail_burst=2,
                                  latency_spike=0.2, spike_s=0.01,
                                  clock_skew=0.1, skew_s=0.05)
        seq = []
        for _ in range(200):
            try:
                inj.on_engine_call(clock)
                seq.append(("ok", clock.now()))
            except serve.ChaosError as e:
                seq.append((str(e), clock.now()))
        runs.append((seq, inj.injected_failures, inj.injected_spikes, inj.injected_skews))
    assert runs[0] == runs[1]
    assert min(runs[0][1:]) > 0


def test_corrupt_artifact_breaks_both_loaders(tmp_path):
    o, r = _synthetic_stack()
    path = str(tmp_path / "stack")
    export_artifact(path, params_from_numpy(o, r, device="cpu"), source="test")
    load_artifact(path)
    jserve.load_artifact(path)
    weights = corrupt_artifact(path)
    assert weights == os.path.join(path, "weights.npz")
    with pytest.raises(tserve.ArtifactCorruptError):
        load_artifact(path)
    with pytest.raises(jserve.ArtifactCorruptError):
        jserve.load_artifact(path)
    assert not tserve.is_valid_artifact(path) and not jserve.is_valid_artifact(path)


def test_launcher_runtime_matches_reference(tmp_path):
    """``serve_dssfn --runtime --manual-clock --chaos`` in both packages
    on one artifact.  ``repro``'s launcher gets ``--use-kernels`` so that
    its engine, like the port's, has a kernel switch for the breaker to
    throw (on this unaligned stack both serve through the plain route)."""
    o, r = _synthetic_stack(layers=3)
    path = str(tmp_path / "stack")
    export_artifact(path, params_from_numpy(o, r, device="cpu"), source="test")
    argv = [
        "--artifact", path, "--runtime", "--manual-clock",
        "--chaos", "fail=0.3:burst=4:seed=7", "--poison-rate", "0.05",
        "--requests", "300", "--batch-bucket", "1,4,8", "--max-batch", "8",
        "--max-pending-samples", "16", "--deadline-ms", "5",
        "--arrival-us", "500", "--seed", "3",
    ]
    logits = str(tmp_path / "logits.npz")
    got = tlaunch.main(argv + ["--device", "cpu", "--save-logits", logits])
    want = jlaunch.main(argv + ["--use-kernels"])
    for key in ("completed", "failed", "rejected", "expired", "mode", "clock", "chaos"):
        assert got[key] == want[key], key
    assert got["snapshot"] == want["snapshot"]
    assert got["degraded_reasons"] == ["kernels-disabled"]
    assert got["device"] == "cpu" and got["kernel_launches"] == 0
    assert got["compile"]["lowerings"] == want["compile"]["lowerings"]
    assert got["completed"] > 0 and got["failed"] > 0 and got["expired"] > 0
    with np.load(logits) as z:
        assert z["requests"].shape == (P, got["completed"])
        assert z["logits"].shape == (Q, got["completed"])
        np.testing.assert_allclose(
            z["logits"], tssfn.predict(
                params_from_numpy(o, r, device="cpu"), torch.from_numpy(z["requests"]), Q
            ).numpy(), **TOL,
        )
