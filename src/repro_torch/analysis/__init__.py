"""repro_torch.analysis — the SPMD contract checker (spmdlint) of the port.

Port of ``repro.analysis``.  Runs consensus programs once at a probe's
size and checks them against the contracts the code declares: eq.-15
wire budgets (``wire``), program-key completeness (``retrace``),
accumulation dtypes and cholesky guarding (``numerics``),
exchange-schedule algebra (``schedule``), source rules (``source``), and
serving bucket programs — zero collectives + dtype discipline
(``serve``).  Every violation is a structured :class:`LintFinding`;
``repro_torch.launch.lint_dssfn`` is the CLI, ``grammar.ALL_GRAMMAR``
the spec table it sweeps.

The reference lowers programs and reads their StableHLO and HLO texts.
PyTorch lowers nothing, so each such check here reads either a record of
the calls the program made (:func:`numerics.recording`, a
``TorchFunctionMode`` plus the kernel wrappers' hook) or the mesh
transport's own counts.  ``__all__`` keeps every reference name that has
a counterpart; the others map so:

- ``lint_jax_callable`` -> :func:`lint_callable` (runs the callable once
  under the recorder);
- ``lint_stablehlo_text`` -> none: there is no text to parse, and
  :func:`lint_record` takes the record itself;
- ``check_serve_texts`` -> :func:`check_serve_record` (a bucket
  program's record and the transports' tally instead of HLO).

The port adds :class:`ProgramRecord`, :class:`CallRecord`,
:func:`recording`, :func:`lint_record` and, for the CLI's one spawn of
ranks, :func:`check_wire_specs`.
"""
from .findings import LintFinding, findings_to_json, render_report
from .grammar import ALL_GRAMMAR, MALFORMED_SPECS, GrammarEntry, grammar_specs
from .numerics import (
    CallRecord,
    ProgramRecord,
    lint_backend_program,
    lint_callable,
    lint_record,
    recording,
)
from .retrace import (
    CACHE_INFO_KEYS,
    check_backend_retrace,
    check_cache_info_schema,
    check_policy_cache_key,
    perturb_policy,
)
from .schedule import check_policy_schedules, check_schedule, schedule_matrix
from .serve import (
    check_serve_contract,
    check_serve_record,
    check_serve_surface,
    synthetic_serve_engine,
)
from .source import lint_source_text, lint_source_tree
from .wire import (
    check_wire_contract,
    check_wire_specs,
    expected_mix_collectives,
    hot_program_texts,
)

__all__ = [
    "ALL_GRAMMAR",
    "CACHE_INFO_KEYS",
    "CallRecord",
    "GrammarEntry",
    "LintFinding",
    "MALFORMED_SPECS",
    "ProgramRecord",
    "check_backend_retrace",
    "check_cache_info_schema",
    "check_policy_cache_key",
    "check_policy_schedules",
    "check_schedule",
    "check_serve_contract",
    "check_serve_record",
    "check_serve_surface",
    "check_wire_contract",
    "check_wire_specs",
    "expected_mix_collectives",
    "findings_to_json",
    "grammar_specs",
    "hot_program_texts",
    "lint_backend_program",
    "lint_callable",
    "lint_record",
    "lint_source_text",
    "lint_source_tree",
    "perturb_policy",
    "recording",
    "render_report",
    "schedule_matrix",
    "synthetic_serve_engine",
]
