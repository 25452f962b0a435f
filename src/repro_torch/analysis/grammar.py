"""The canonical ``parse_spec`` grammar table the linter enumerates.

Port of ``repro/analysis/grammar.py``: the port keeps its own copy of the
table, entry for entry the reference's, and :func:`parse_all` runs it
through :func:`repro_torch.dssfn.parse_spec`.  ``--all-grammar`` runs
every check over this table, so it is the single place that answers
"which policy x topology x fault-model specs does the repo promise to
support?".  Every entry must parse, every mode in ``policy._MODES`` must
be exercised, and every malformed entry in :data:`MALFORMED_SPECS` must
be rejected with the documented hint.

Entries with ``wire_check=False`` still go through the schedule /
retrace / numerics checks but are excluded from the wire budget: the
time-varying phase rotation's collective count per mix depends on the
mix's index (round b talks on phase b mod L, and the index runs on
across mixes), and the geometric graph's schedule depth depends on its
seed, so neither has one closed-form count per mix.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GrammarEntry:
    spec: str
    description: str
    wire_check: bool = True


#: Every supported policy mode, across representative topology, wire
#: format, fault-model, and interval settings.  Kept small enough that
#: the linter can run each entry's hot program, while still covering
#: every ``mix`` code path once.
ALL_GRAMMAR: tuple[GrammarEntry, ...] = (
    GrammarEntry("exact", "one all-reduce per mix (true mean)"),
    GrammarEntry("gossip", "single serial ring round"),
    GrammarEntry("gossip:3", "3 ring rounds, compressed to H**3"),
    GrammarEntry("gossip:4:2", "4 rounds on the degree-2 ring"),
    GrammarEntry("gossip:2@torus:2x4", "compressed torus gossip"),
    GrammarEntry("gossip:2@hypercube", "compressed hypercube gossip"),
    GrammarEntry("gossip:3:wire=bf16", "bf16 link payloads, f32 accum"),
    GrammarEntry("gossip:2:wire=f16", "f16 link payloads, f32 accum"),
    GrammarEntry("quantized", "8-bit stochastic quantized all-reduce"),
    GrammarEntry("quantized:4", "4-bit stochastic quantized all-reduce"),
    GrammarEntry("quantized:8@ring:2", "quantized gossip over a ring"),
    GrammarEntry("lossy:0.2:2:2", "lossy degree-2 ring, 2 rounds"),
    GrammarEntry("lossy:0.1@hypercube", "lossy hypercube links"),
    GrammarEntry("stale:1", "delay-1 stale all-reduce mixing"),
    GrammarEntry("stale:2", "delay-2 stale all-reduce mixing"),
    GrammarEntry("stale:1@ring:2", "stale mixing over a ring schedule"),
    GrammarEntry("async:rounds=2", "serial async gossip, every round"),
    GrammarEntry("async:interval=2:rounds=2", "mix every 2nd iteration"),
    GrammarEntry("async:interval=4@ring:2", "sparse interval-4 gossip"),
    GrammarEntry("async:drop=0.2:seed=3@hypercube", "seeded link drops"),
    GrammarEntry(
        "async:rounds=2@ring:1+hypercube",
        "time-varying phase rotation (lax.switch branches)",
        wire_check=False,
    ),
    GrammarEntry("trimmed:f=1:attack=signflip", "screened trimmed mean"),
    GrammarEntry(
        "trimmed:f=1:attack=scale:10@hypercube", "trimmed mean, scale attack"
    ),
    GrammarEntry("median:attack=noise:0.5@ring:2", "coordinate-wise median"),
    GrammarEntry("clipped:0.5:attack=nanbomb", "centered clipping, tau=0.5"),
    GrammarEntry(
        "clipped:tau=2.0:byz=0+3:attack=replay:2@torus:2x4",
        "clipping under two replay attackers",
    ),
    # Parse/schedule-only entries: geometric graphs draw an irregular
    # Birkhoff schedule (seed-dependent depth), so there is no closed-form
    # expected hop count to hold the wire counts to.
    GrammarEntry(
        "gossip:2@geometric:0.9", "irregular geometric graph",
        wire_check=False,
    ),
)


#: Malformed specs and the error fragment the parser must include.
#: ``lint_dssfn --all-grammar`` does NOT run these; the parse-error test
#: suite round-trips them so every rejection path keeps its hint.
MALFORMED_SPECS: tuple[tuple[str, str], ...] = (
    ("bogus", "unknown consensus policy"),
    ("gossip:x", "bad consensus policy spec"),
    ("gossip:1:2:3", "takes at most"),
    ("exact@ring", "takes no topology"),
    ("gossip:2:2@hypercube", "not both"),
    ("quantized:64", "quantization bits"),
    ("quantized:8:wire=bf16", "takes no wire="),
    ("lossy:1.5", "drop_prob"),
    ("lossy:0.1:2:2@ring:2", "not both"),
    ("stale:-1", "staleness delay"),
    ("stale:1@ring:1+hypercube", "time-varying"),
    ("async:bogus=1", "unknown async key"),
    ("async:interval=0", "communication interval"),
    ("async:rounds=0", "rounds must be >= 1"),
    ("trimmed:f=0", "f >= 1"),
    ("median:rounds=0", "rounds must be >= 1"),
    ("clipped:0.5:tau=1", "not both"),
    ("clipped:tau=-1", "tau must be > 0"),
    ("gossip@mobius", "unknown topology"),
    ("gossip@torus:5", "torus spec is torus:RxC"),
    ("gossip@ring:1:2", "at most one"),
    ("gossip@geometric", "geometric spec is"),
)


def grammar_specs(*, wire_only: bool = False) -> list[str]:
    return [
        e.spec for e in ALL_GRAMMAR if e.wire_check or not wire_only
    ]


def parse_all(num_workers: int | None = None):
    """Parse every grammar entry, optionally validating against a
    worker count; returns ``[(entry, policy), ...]``.  A parse failure
    here means the table and the grammar drifted apart — that IS the
    lint, so let it raise."""
    from repro_torch import dssfn

    out = []
    for entry in ALL_GRAMMAR:
        policy = dssfn.parse_spec(entry.spec)
        if num_workers is not None:
            policy.validate(num_workers)
        out.append((entry, policy))
    return out
