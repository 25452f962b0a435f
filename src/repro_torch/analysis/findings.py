"""Structured diagnostics for the static SPMD contract checker.

Port of ``repro/analysis/findings.py``, verbatim: the JSON schema is
the reference's.  Every checker in ``repro_torch.analysis`` reports
:class:`LintFinding` values instead of raising or printing: a finding
names the check that fired,
the subject it fired on (a policy spec, a schedule, a source location),
and enough detail to reproduce the violation.  ``lint_dssfn`` renders
findings as text or JSON and exits non-zero when any exist.

The JSON schema (one object per finding) is stable::

    {"check": str,       # e.g. "wire-count", "numerics-accum"
     "severity": "error" | "warning",
     "subject": str,     # what was checked (spec string, file:line, ...)
     "message": str,     # one-line human description
     "details": {...}}   # check-specific evidence (declared vs measured)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class LintFinding:
    """One contract violation found by a static check."""

    check: str
    subject: str
    message: str
    severity: str = "error"
    details: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    def to_dict(self) -> dict:
        return {
            "check": self.check,
            "severity": self.severity,
            "subject": self.subject,
            "message": self.message,
            "details": self.details,
        }

    def render(self) -> str:
        head = f"{self.severity.upper()} [{self.check}] {self.subject}: {self.message}"
        if not self.details:
            return head
        body = "\n".join(
            f"    {k} = {v!r}" for k, v in sorted(self.details.items())
        )
        return head + "\n" + body


def findings_to_json(findings: list[LintFinding]) -> str:
    """The CI artifact payload: a stable, sorted JSON document."""
    ordered = sorted(findings, key=lambda f: (f.check, f.subject, f.message))
    return json.dumps(
        {
            "findings": [f.to_dict() for f in ordered],
            "count": len(ordered),
            "errors": sum(1 for f in ordered if f.severity == "error"),
        },
        indent=2,
        sort_keys=True,
        default=str,
    )


def render_report(findings: list[LintFinding]) -> str:
    if not findings:
        return "spmdlint: no findings"
    lines = [f.render() for f in sorted(
        findings, key=lambda f: (f.check, f.subject, f.message))]
    lines.append(
        f"spmdlint: {len(findings)} finding(s), "
        f"{sum(1 for f in findings if f.severity == 'error')} error(s)"
    )
    return "\n".join(lines)
