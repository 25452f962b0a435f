"""Seeded fault injection for serving chaos drills.

Port of ``repro/serve/chaos.py``.  A :class:`ChaosInjector` hangs off
:class:`~repro_torch.serve.runtime.ServeRuntime` (``chaos=``) and fires
inside the engine-forward wrapper, so every failure path the runtime
claims to handle can be drilled on demand:

- **engine raises** (``fail=P`` with optional ``burst=K``): the engine
  call raises :class:`ChaosError` — a :class:`TransientEngineError`, so
  the runtime's retry/backoff and circuit-breaker paths exercise, not
  the poison-bisect path.  A burst of K makes consecutive failures long
  enough to open the breaker deterministically.
- **latency spikes** (``spike=P`` at ``spike_s=S``): the engine call
  sleeps first — on a ``ManualClock`` this advances virtual time, which
  is how the deadline-shedding drills make requests expire.
- **clock skew** (``skew=P`` at ``skew_s=S``): virtual time jumps
  forward on a :class:`~repro_torch.serve.runtime.ManualClock` (a wall clock
  cannot be skewed — ignored there), modelling NTP steps that
  retroactively expire deadlines.
- **artifact corruption**: :func:`corrupt_artifact` flips bytes in an
  exported artifact's weights on disk, for the reload-under-fire drills.

Everything is driven by one ``numpy`` Generator seeded at construction,
drawn in ``repro``'s order: the same seed replays the same fault
schedule in both packages, so drills assert on exact breaker
transitions rather than rates.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.export import WEIGHTS_NAME
from repro_torch.serve.runtime import ManualClock, TransientEngineError


class ChaosError(TransientEngineError):
    """An injected (environmental, retryable) engine failure."""


@dataclass
class ChaosInjector:
    """Seeded fault schedule for the runtime's engine-call path.

    chaos = ChaosInjector(seed=0, engine_fail=0.2, fail_burst=3)
    rt = ServeRuntime(engine, clock=ManualClock(), chaos=chaos)
    """

    seed: int = 0
    #: Probability an engine call raises :class:`ChaosError`.
    engine_fail: float = 0.0
    #: Once a failure fires, how many consecutive calls fail (>= 1).
    fail_burst: int = 1
    #: Probability an engine call is preceded by a latency spike.
    latency_spike: float = 0.0
    spike_s: float = 0.05
    #: Probability virtual time jumps forward before an engine call.
    clock_skew: float = 0.0
    skew_s: float = 0.1
    injected_failures: int = field(default=0, init=False)
    injected_spikes: int = field(default=0, init=False)
    injected_skews: int = field(default=0, init=False)
    _burst_left: int = field(default=0, init=False)
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        for name in ("engine_fail", "latency_spike", "clock_skew"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if self.fail_burst < 1:
            raise ValueError(f"fail_burst must be >= 1, got {self.fail_burst}")
        self._rng = np.random.default_rng(self.seed)

    def on_engine_call(self, clock) -> None:
        """Called by the runtime immediately before each engine forward;
        raises :class:`ChaosError` when an engine fault fires."""
        if self.latency_spike and self._rng.random() < self.latency_spike:
            self.injected_spikes += 1
            clock.sleep(self.spike_s)
        if self.clock_skew and isinstance(clock, ManualClock):
            if self._rng.random() < self.clock_skew:
                self.injected_skews += 1
                clock.advance(self.skew_s)
        if self._burst_left > 0:
            self._burst_left -= 1
            self.injected_failures += 1
            raise ChaosError(
                f"injected engine fault (burst, {self._burst_left} left)"
            )
        if self.engine_fail and self._rng.random() < self.engine_fail:
            self._burst_left = self.fail_burst - 1
            self.injected_failures += 1
            raise ChaosError("injected engine fault")

    def describe(self) -> str:
        return (
            f"ChaosInjector(seed={self.seed}, fail={self.engine_fail}"
            f"x{self.fail_burst}, spike={self.latency_spike}@"
            f"{self.spike_s}s, skew={self.clock_skew}@{self.skew_s}s)"
        )


def parse_chaos(spec: str) -> ChaosInjector:
    """Build an injector from a CLI spec: colon-separated ``key=value``
    pairs, e.g. ``"fail=0.2:burst=3:spike=0.05:seed=7"``.  Keys:
    ``fail``, ``burst``, ``spike``, ``spike_s``, ``skew``, ``skew_s``,
    ``seed``."""
    keymap = {
        "fail": ("engine_fail", float),
        "burst": ("fail_burst", int),
        "spike": ("latency_spike", float),
        "spike_s": ("spike_s", float),
        "skew": ("clock_skew", float),
        "skew_s": ("skew_s", float),
        "seed": ("seed", int),
    }
    kwargs = {}
    for part in spec.split(":"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"chaos spec parts are key=value, got {part!r} in {spec!r}"
            )
        key, value = part.split("=", 1)
        if key not in keymap:
            raise ValueError(
                f"unknown chaos key {key!r}; known: {sorted(keymap)}"
            )
        name, cast = keymap[key]
        kwargs[name] = cast(value)
    return ChaosInjector(**kwargs)


def corrupt_artifact(path: str, *, offset: int = 128, nbytes: int = 64) -> str:
    """Flip ``nbytes`` bytes of an exported artifact's weights file in
    place (reload-under-fire drills: the manifest checksum no longer
    matches, so ``load_artifact`` raises ``ArtifactCorruptError``).
    Returns the corrupted file's path."""
    weights = os.path.join(path, WEIGHTS_NAME)
    with open(weights, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            raise ValueError(f"empty weights file: {weights}")
        start = min(offset, max(0, size - nbytes))
        f.seek(start)
        chunk = f.read(min(nbytes, size - start))
        f.seek(start)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return weights
