"""spmdlint CLI: check the port's SPMD programs against their contracts.

Port of ``repro/launch/lint_dssfn.py``.  Usage::

    python -m repro_torch.launch.lint_dssfn --all-grammar
    python -m repro_torch.launch.lint_dssfn --spec gossip:3 --spec exact
    python -m repro_torch.launch.lint_dssfn --all-grammar --format=json --out findings.json
    python -m repro_torch.launch.lint_dssfn --checks schedule,source --all-grammar
    python -m repro_torch.launch.lint_dssfn --all-grammar --device cpu

Per spec the linter runs (each program once, at the probe's size):

- ``schedule``  exchange-schedule algebra (doubly-stochastic, weights,
                inverse-closure under faults, compressed H**B)
- ``retrace``   program-key completeness (field perturbation, value level)
- ``wire``      the transport's collective counts / payload dtypes vs
                the declared eq.-15 budget, from one group of M gloo
                ranks (one worker a rank) spawned for the whole spec list
- ``numerics``  accumulation-dtype + guarded-cholesky lint of the hot
                program's call record, in this process on a
                ``SimulatedBackend``
- ``source``    AST rules over ``src/repro_torch`` (once, not per spec)
- ``serve``     ServeEngine bucket programs: zero collectives + dtype
                discipline through the feature extractors (once, not
                per spec; single-device)

``wire``, ``numerics`` and ``serve`` run on ``--device`` (default
``cuda``, which must exist; ``--device cpu`` on a host without a card).
On the card the wire probe's ranks share it, staging their messages
through pinned host memory.  ``--no-host-mesh`` spawns no ranks: the
``wire`` check then reports a ``wire-environment`` warning instead, as
the reference does without devices, and ``numerics`` still runs.

Exit status is the number of findings (0 = clean), capped at 125.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

CHECKS = ("schedule", "retrace", "wire", "numerics", "source", "serve")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="lint_dssfn", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--spec", action="append", default=[],
        help="policy[@topology] spec to lint (repeatable)",
    )
    ap.add_argument(
        "--all-grammar", action="store_true",
        help="lint every entry of repro_torch.analysis.grammar.ALL_GRAMMAR",
    )
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument(
        "--iters", type=int, default=8,
        help="ADMM iterations in the wire and numerics probes",
    )
    ap.add_argument(
        "--checks", default=",".join(CHECKS),
        help=f"comma-separated subset of {CHECKS}",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, help="also write JSON findings here")
    ap.add_argument(
        "--no-host-mesh", action="store_true",
        help="spawn no ranks: the wire check reports a wire-environment "
        "warning instead of probing (numerics still runs in this process)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the wire, numerics and serve probes (default: "
        "cuda, which must exist)",
    )
    return ap.parse_args(argv)


def lint(args) -> list:
    """Run the selected checks; returns the findings list."""
    checks = [c.strip() for c in args.checks.split(",") if c.strip()]
    unknown = sorted(set(checks) - set(CHECKS))
    if unknown:
        raise SystemExit(f"unknown checks {unknown}; pick from {CHECKS}")

    from repro_torch import analysis, dssfn

    dev = None
    if {"wire", "numerics", "serve"} & set(checks):
        from repro_torch._device import resolve_device

        dev = resolve_device(args.device)

    specs = list(args.spec)
    if args.all_grammar or not specs:
        specs += analysis.grammar_specs()
    entry_by_spec = {e.spec: e for e in analysis.ALL_GRAMMAR}

    findings: list[analysis.LintFinding] = []
    m = args.num_workers

    policies = []
    for spec in specs:
        try:
            policy = dssfn.parse_spec(spec)
            policy.validate(m)
        except (ValueError, TypeError) as e:
            findings.append(analysis.LintFinding(
                check="grammar-parse",
                subject=spec,
                message=f"grammar entry does not parse/validate: {e}",
            ))
            continue
        policies.append((spec, policy))

    if "schedule" in checks:
        for spec, policy in policies:
            findings.extend(
                analysis.check_policy_schedules(policy, m, subject=spec)
            )
    if "retrace" in checks:
        for spec, policy in policies:
            findings.extend(
                analysis.check_policy_cache_key(policy, m, subject=spec)
            )

    probed = [
        (spec, policy) for spec, policy in policies
        if entry_by_spec.get(spec) is None or entry_by_spec[spec].wire_check
    ]
    if "wire" in checks:
        if args.no_host_mesh:
            findings.append(analysis.LintFinding(
                check="wire-environment",
                subject="no ranks",
                message=(
                    f"the wire probe needs {m} ranks and --no-host-mesh "
                    f"spawns none; drop it to spawn {m} gloo ranks on "
                    "this host"
                ),
                severity="warning",
            ))
        elif probed:
            findings.extend(analysis.check_wire_specs(
                [spec for spec, _ in probed], num_workers=m,
                num_iters=args.iters, device=dev,
            ))
    if "numerics" in checks:
        from repro_torch.core.backend import SimulatedBackend

        backend = SimulatedBackend(m)
        for spec, policy in probed:
            texts = analysis.hot_program_texts(
                backend, policy, device=dev,
                num_iters=analysis.wire.probe_iters(policy, args.iters),
            )
            findings.extend(
                analysis.lint_record(texts["program"], subject=spec)
            )

    if "source" in checks:
        src_root = Path(__file__).resolve().parents[1]
        findings.extend(analysis.lint_source_tree(src_root))
    if "serve" in checks:
        findings.extend(analysis.check_serve_surface(device=dev))
    return findings


def main(argv=None) -> int:
    args = parse_args(argv)
    findings = lint(args)

    from repro_torch.analysis import findings_to_json, render_report

    payload = findings_to_json(findings)
    if args.out:
        Path(args.out).write_text(payload + os.linesep)
    if args.format == "json":
        print(payload)
    else:
        print(render_report(findings))
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
