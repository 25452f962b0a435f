"""repro_torch.analysis (the port's spmdlint) against repro.analysis.

Each case of ``tests/test_analysis.py`` held against the port: every
checker fires on a seeded mutation and stays silent on the clean tree,
and a mutation fires the same check in the port as in ``repro``.  The
device-free findings (schedule, retrace, grammar-parse) over
``ALL_GRAMMAR`` and ``MALFORMED_SPECS`` at M=8 equal ``repro``'s as
``(check, subject)`` sets, and the two grammar tables are equal entry for
entry.  The numerics checks run the program once on the CPU under the
recorder (``repro`` lowers it); the kernel hook is exercised under a
stubbed CUDA wrapper.  The mesh wire probe lives in
``tests/test_torch_analysis_wire.py``.
"""
import dataclasses
import json
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch

from repro_torch import analysis, dssfn
from repro_torch.core import admm
from repro_torch.core import policy as policy_lib
from repro_torch.core.backend import SimulatedBackend
from repro_torch.core.policy import (
    AsyncGossip,
    ExactMean,
    Gossip,
    QuantizedGossip,
    StaleMixing,
)
from repro_torch.core.topology import (
    ExchangeSchedule,
    Hypercube,
    Ring,
    cached_exchange_schedule,
)
from repro_torch.kernels import _record

M = 8
CPU = "cpu"


def _checks(findings):
    return sorted({f.check for f in findings})


def _pairs(findings):
    return {(f.check, f.subject) for f in findings}


# ---------------------------------------------------------------- findings


def test_finding_schema_and_rendering():
    from repro import analysis as janalysis

    f = analysis.LintFinding(
        check="wire-count", subject="gossip:3", message="mismatch",
        details={"expected": 3},
    )
    d = f.to_dict()
    assert d == {
        "check": "wire-count", "severity": "error", "subject": "gossip:3",
        "message": "mismatch", "details": {"expected": 3},
    }
    assert "ERROR [wire-count] gossip:3: mismatch" in f.render()
    assert "expected = 3" in f.render()
    with pytest.raises(ValueError, match="severity"):
        analysis.LintFinding(
            check="x", subject="y", message="z", severity="fatal"
        )
    g = dataclasses.replace(f, details={})
    assert g == f

    payload = json.loads(analysis.findings_to_json([f, g]))
    assert payload["count"] == 2 and payload["errors"] == 2
    assert payload["findings"][0]["check"] == "wire-count"
    assert analysis.render_report([]) == "spmdlint: no findings"
    assert "2 finding(s), 2 error(s)" in analysis.render_report([f, g])
    # The JSON and the text report are the reference's, byte for byte.
    jf = janalysis.LintFinding(**d)
    jg = dataclasses.replace(jf, details={})
    assert analysis.findings_to_json([f, g]) == janalysis.findings_to_json([jf, jg])
    assert analysis.render_report([f, g]) == janalysis.render_report([jf, jg])


# ---------------------------------------------------------------- schedule


def test_schedule_checker_clean_on_library_schedules():
    sched = cached_exchange_schedule(Hypercube(), M)
    assert analysis.check_schedule(
        sched, subject="hypercube",
        expect_inverse_closed=True, expect_symmetric=True,
    ) == []


def _directed(schedule_type):
    return schedule_type(
        num_workers=4,
        perms=(tuple((i, (i + 1) % 4) for i in range(4)),),
        weights=(0.5,), self_weight=0.5,
    )


def test_schedule_inverse_closure_mutation():
    directed = _directed(ExchangeSchedule)
    assert analysis.check_schedule(directed, subject="directed-ring") == []
    found = analysis.check_schedule(
        directed, subject="directed-ring", expect_inverse_closed=True
    )
    assert _checks(found) == ["schedule-inverse-closure"]


_PERMS = (tuple((i, (i + 1) % 4) for i in range(4)),)


@pytest.mark.parametrize("weights,self_weight,symmetric,want", [
    ((0.7,), 0.5, False, ["schedule-doubly-stochastic", "schedule-weight-sum"]),
    ((-0.2,), 1.2, False, ["schedule-nonnegative", "schedule-weights"]),
    ((0.5,), 0.5, True, ["schedule-symmetry"]),
])
def test_schedule_weight_mutations(weights, self_weight, symmetric, want):
    sched = ExchangeSchedule(
        num_workers=4, perms=_PERMS, weights=weights, self_weight=self_weight
    )
    assert _checks(analysis.check_schedule(
        sched, subject="s", expect_symmetric=symmetric
    )) == want


def test_policy_schedules_clean_across_grammar():
    for entry, policy in analysis.grammar.parse_all(M):
        assert analysis.check_policy_schedules(
            policy, M, subject=entry.spec
        ) == [], entry.spec


# ---------------------------------------------------------------- numerics


def test_numerics_accum_mutation_fires():
    def f16_prog(a, b):
        return (a.to(torch.float16) @ b.to(torch.float16)).to(torch.float32)

    a = torch.zeros((4, 8))
    b = torch.zeros((8, 4))
    found = analysis.lint_callable(f16_prog, a, b, subject="f16-accum")
    assert "numerics-accum" in _checks(found)
    assert any(f.details.get("dtype") == "f16" for f in found)
    assert analysis.lint_callable(
        lambda a, b: a @ b, a, b, subject="f32-accum"
    ) == []
    # Every accumulating call is judged by its result; pure data movement
    # at half width is not.
    for prog in (lambda a, b: a.bfloat16() + a.bfloat16(),
                 lambda a, b: a.bfloat16().sum(0),
                 lambda a, b: torch.einsum("ij,jk->ik", a.half(), b.half()),
                 lambda a, b: torch.zeros(4, 8).bfloat16().index_add_(
                     0, torch.tensor([0]), a[:1].bfloat16())):
        assert _checks(analysis.lint_callable(prog, a, b, subject="p")) == ["numerics-accum"]
    assert analysis.lint_callable(
        lambda a, b: a.bfloat16().index_select(0, torch.tensor([1, 0])).float(),
        a, b, subject="move") == []


def test_numerics_cholesky_guard_detection():
    g = torch.eye(6) * 2.0
    for raw in (torch.linalg.cholesky, lambda m: torch.linalg.cholesky_ex(m)[0],
                torch.cholesky):
        assert _checks(analysis.lint_callable(raw, g, subject="raw")) == ["numerics-cholesky"]
    guarded = analysis.lint_callable(
        lambda m: admm.guarded_cholesky(m)[0], g, subject="guarded"
    )
    assert "numerics-cholesky" not in _checks(guarded)
    # Stricter than the reference: one raw factorization beside a guarded
    # one still fires.
    both = analysis.lint_callable(
        lambda m: (admm.guarded_cholesky(m)[0], torch.linalg.cholesky(m)), g, subject="both"
    )
    assert _checks(both) == ["numerics-cholesky"]


def test_numerics_backend_program_clean():
    backend = SimulatedBackend(4)
    x = torch.ones((4, 3, 5))
    assert analysis.lint_backend_program(
        backend, lambda x: x @ x.mT, x, subject="sim-worker"
    ) == []
    assert backend.cache_info()["entries"] == 1


@dataclasses.dataclass(frozen=True)
class HalfReceive(Gossip):
    """Mutation: a bf16 wire whose receiver adds the messages at wire
    precision (the missing f32 convert the wire contract forbids)."""

    def mix(self, x, state, ctx):
        sched = cached_exchange_schedule(self.topology, ctx.num_workers)
        wire = x.to(torch.bfloat16)
        acc = wire
        for perm in sched.perms:
            acc = acc + ctx.ppermute(wire, perm)
        return acc.to(x.dtype) / (len(sched.perms) + 1), state


def test_numerics_hot_program_clean_across_grammar_and_fires_on_half_receive():
    """The CLI's numerics probe over every wire-checked entry is clean;
    a receive-side bf16 accumulate is caught."""
    backend = SimulatedBackend(M)
    for spec in analysis.grammar_specs(wire_only=True):
        policy = dssfn.parse_spec(spec)
        texts = analysis.hot_program_texts(
            backend, policy, num_iters=analysis.wire.probe_iters(policy, 8), device=CPU,
        )
        assert analysis.lint_record(texts["program"], subject=spec) == [], spec
        assert "linalg_cholesky_ex" in texts["program"].counts()
    bad = HalfReceive(rounds=1, wire_dtype="bfloat16")
    texts = analysis.hot_program_texts(backend, bad, num_iters=4, device=CPU)
    assert _checks(analysis.lint_record(texts["program"], subject="half")) == ["numerics-accum"]


# ---------------------------------------------------------------- kernels


def _stub_launch(monkeypatch, kernel_module):
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(kernel_module, "_check", lambda *a: None)
    monkeypatch.setattr(kernel_module, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())


def _kernel_call(name, dtype):
    r = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
    if name == "matmul_relu":
        from repro_torch.kernels.matmul_relu import kernel as mod
        return mod, lambda: mod.matmul_relu_cuda(r(4, 3), r(3, 2))
    if name == "gram":
        from repro_torch.kernels.gram import kernel as mod
        return mod, lambda: mod.gram_cuda(r(2, 3, 5), mu=1.0)
    if name == "propagate_gram":
        from repro_torch.kernels.propagate_gram import kernel as mod
        return mod, lambda: mod.propagate_gram_cuda(r(4, 3), r(2, 3, 5), mu=1.0)
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import kernel as mod
        return mod, lambda: mod.flash_attention_cuda(r(1, 2, 4, 8), r(1, 2, 4, 8), r(1, 2, 4, 8))
    if name == "ssm_scan":
        from repro_torch.kernels.ssm_scan import kernel as mod
        return mod, lambda: mod.ssm_scan_cuda(
            r(1, 4, 2, 3), r(1, 4, 2), r(2), r(1, 4, 5), r(1, 4, 5), chunk=2)
    from repro_torch.kernels.mlstm_scan import kernel as mod
    return mod, lambda: mod.mlstm_scan_cuda(
        r(1, 4, 2, 8), r(1, 4, 2, 8), r(1, 4, 2, 8), r(1, 4, 2), r(1, 4, 2), chunk=2)


KERNELS = ("matmul_relu", "gram", "propagate_gram", "flash_attention", "ssm_scan",
           "mlstm_scan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_hook_reports_launch_with_declared_accumulation(monkeypatch, name, dtype):
    """Under a stubbed CUDA wrapper (the launch returns success, nothing
    runs) every kernel reports itself to a recording once, with its f32
    accumulation; outside a recording the hook is None."""
    mod, call = _kernel_call(name, dtype)
    _stub_launch(monkeypatch, mod)
    assert mod.ACCUM_DTYPE == torch.float32
    before = mod.launch_count()
    assert _record.hook is None
    call()  # nothing records: the hook stays None and is not called
    with analysis.recording() as record:
        out = call()
    assert _record.hook is None
    assert mod.launch_count() == before + 2
    (kernel,) = record.kernels()
    assert kernel.name == f"kernel:{name}" and kernel.accum_dtype == "f32"
    first = out[0] if isinstance(out, tuple) else out
    assert kernel.shapes[0] == tuple(first.shape)
    assert kernel.dtypes[0] == analysis.numerics.short_dtype(first.dtype)
    # Judged by its declared accumulation, not its (bf16) result.
    assert analysis.lint_record(record, subject=name) == []


def test_recording_restores_the_hook_after_a_failure():
    with pytest.raises(RuntimeError, match="boom"):
        with analysis.recording():
            assert _record.hook is not None
            raise RuntimeError("boom")
    assert _record.hook is None


def test_kernel_record_in_half_precision_fires():
    record = analysis.ProgramRecord()
    record.add_kernel("matmul_relu", torch.bfloat16, torch.zeros(2, 2, dtype=torch.bfloat16))
    assert _checks(analysis.lint_record(record, subject="k")) == ["numerics-accum"]


# ---------------------------------------------------------------- retrace


@dataclasses.dataclass(frozen=True)
class LeakyGossip(Gossip):
    """Mutation: a config field excluded from equality/hash — two
    distinct configurations share one program entry."""

    hidden: int = dataclasses.field(default=1, compare=False)


def test_retrace_value_level_clean_across_grammar():
    for entry, policy in analysis.grammar.parse_all(M):
        assert analysis.check_policy_cache_key(
            policy, M, subject=entry.spec
        ) == [], entry.spec


def test_retrace_key_collision_mutation_fires():
    found = analysis.check_policy_cache_key(
        LeakyGossip(rounds=2), M, subject="leaky"
    )
    assert _checks(found) == ["retrace-key-collision"]
    assert any(f.details.get("field") == "hidden" for f in found)


def test_perturb_policy_varies_every_constructible_field():
    base = AsyncGossip(
        interval=2, rounds=2, topology=Ring(2),
        faults=policy_lib.FaultModel(drop=0.1, seed=3),
    )
    variants = dict(analysis.perturb_policy(base, M))
    for field_name in ("interval", "rounds", "topology", "faults"):
        assert field_name in variants
        assert variants[field_name] != base
        variants[field_name].validate(M)
    # LossyGossip's hand-written __init__ (degree is no field) survives
    # dataclasses.replace.
    lossy = dssfn.parse_spec("lossy:0.2:2:2")
    assert dataclasses.replace(lossy) == lossy
    assert {f for f, _ in analysis.perturb_policy(lossy, M)} >= {"drop_prob", "rounds"}


def test_backend_retrace_probe_clean():
    backend = SimulatedBackend(4)
    assert analysis.check_backend_retrace(
        backend, Gossip(rounds=2), 4, subject="gossip:2", device=CPU
    ) == []
    # The probe itself populated the record: base + 2 perturbed variants.
    info = backend.cache_info()
    assert info["entries"] == 3 and info["cache_hits"] >= 1


class _ForgetfulBackend(SimulatedBackend):
    """Mutation: a program record that leaves the policy out of the key."""

    def _call(self, fn, stacked_args, replicated, key, policy, *, collective):
        return super()._call(fn, stacked_args, replicated, key, None, collective=collective)


@dataclasses.dataclass(frozen=True)
class _IdentityGossip(Gossip):
    """Mutation: identity equality, so equal configurations differ."""

    __eq__ = object.__eq__
    __hash__ = object.__hash__


@pytest.mark.parametrize("backend,policy,want", [
    (_ForgetfulBackend, Gossip(rounds=2), ["retrace-stale"]),
    (SimulatedBackend, _IdentityGossip(rounds=2), ["retrace-spurious"]),
])
def test_backend_retrace_mutations_fire(backend, policy, want):
    found = analysis.check_backend_retrace(backend(4), policy, 4, subject="m", device=CPU)
    assert _checks(found) == want


def test_cache_info_schema_checker():
    ok = {"entries": 1, "lowerings": 2, "cache_hits": 0, "keys": ["k"]}
    assert analysis.check_cache_info_schema(ok, subject="s") == []
    missing = analysis.check_cache_info_schema({"entries": 1}, subject="s")
    assert _checks(missing) == ["retrace-cache-schema"]
    skewed = analysis.check_cache_info_schema({**ok, "keys": []}, subject="s")
    assert _checks(skewed) == ["retrace-cache-schema"]
    assert analysis.CACHE_INFO_KEYS == ("entries", "lowerings", "cache_hits", "keys")


# ---------------------------------------------------------------- wire model


def test_expected_mix_collectives_model():
    from repro import analysis as janalysis
    from repro.core import policy as jp
    from repro.core import topology as jt

    assert analysis.expected_mix_collectives(ExactMean(), M) == {"all-reduce": 1}
    assert analysis.expected_mix_collectives(QuantizedGossip(bits=8), M) == {
        "all-reduce": 1
    }
    g = Gossip(rounds=3)
    assert analysis.expected_mix_collectives(g, M) == {
        "collective-permute": g.hops_for(M)
    }
    stale = StaleMixing(1, topology=Ring(2))
    hops = len(cached_exchange_schedule(Ring(2), M).perms)
    assert analysis.expected_mix_collectives(stale, M) == {"collective-permute": hops}
    assert analysis.expected_mix_collectives(stale, M) == janalysis.expected_mix_collectives(
        jp.StaleMixing(1, topology=jt.Ring(2)), M)
    # The whole grammar, port vs reference.
    for entry, policy in analysis.grammar.parse_all(M):
        if entry.wire_check:
            from repro import dssfn as jdssfn

            assert analysis.expected_mix_collectives(policy, M) == \
                janalysis.expected_mix_collectives(jdssfn.parse_spec(entry.spec), M), entry.spec


def test_probe_iters_rounds_to_interval():
    assert analysis.wire.probe_iters(ExactMean(), 8) == 8
    sparse = AsyncGossip(interval=4)
    assert analysis.wire.probe_iters(sparse, 6) == 8
    assert analysis.wire.probe_iters(sparse, 1) == 4


# ---------------------------------------------------------------- source


_BAD_SOURCE = """
import time
import torch
from repro_torch import prng


def make_key():
    return prng.PRNGKey(int(time.time()))


def make_generator():
    return torch.Generator().manual_seed(int(time.time_ns()))


class P:
    def mix(self, x, state, ctx):
        if x.sum() > 0:
            return x, state
        return -x, state
"""

_CLEAN_SOURCE = """
import torch
from repro_torch import prng


def make_key():
    torch.manual_seed(0)
    return prng.PRNGKey(0)


class P:
    rounds = 2

    def mix(self, x, state, ctx):
        if state is None:
            state = 0
        if self.rounds > 0:
            return x, state
        return -x, state
"""


def test_source_lint_mutations_fire():
    found = analysis.lint_source_text(_BAD_SOURCE, filename="bad.py")
    assert _checks(found) == ["source-prng-seed", "source-traced-branch"]
    assert sum(f.check == "source-prng-seed" for f in found) == 2
    assert "host sync" in next(f.message for f in found if f.check == "source-traced-branch")
    assert analysis.lint_source_text(_CLEAN_SOURCE, filename="ok.py") == []
    broken = analysis.lint_source_text("def f(:\n", filename="broken.py")
    assert _checks(broken) == ["source-syntax"]
    for seed in ("torch.manual_seed(torch.seed())", "torch.cuda.manual_seed()",
                 "torch.manual_seed(int.from_bytes(os.urandom(4), 'little'))",
                 "prng.key(random.getrandbits(32))"):
        assert _checks(analysis.lint_source_text(seed, filename="s.py")) == [
            "source-prng-seed"], seed


def test_source_lint_clean_over_repo():
    src = Path(__file__).resolve().parents[1] / "src"
    assert analysis.lint_source_tree(src / "repro_torch") == []
    # The reference's rules find nothing in the port either.
    from repro import analysis as janalysis

    assert janalysis.lint_source_tree(src / "repro_torch") == []


# ---------------------------------------------------------------- grammar


def test_grammar_table_parses_and_validates():
    parsed = analysis.grammar.parse_all(M)
    assert len(parsed) == len(analysis.ALL_GRAMMAR)
    heads = {e.spec.split("@")[0].split(":")[0] for e in analysis.ALL_GRAMMAR}
    assert heads == set(policy_lib._MODES)
    wire = set(analysis.grammar_specs(wire_only=True))
    assert wire < set(analysis.grammar_specs())
    assert "async:rounds=2@ring:1+hypercube" not in wire
    assert "gossip:2@geometric:0.9" not in wire
    assert len(wire) == 25


def test_grammar_tables_equal_the_reference():
    from repro import analysis as janalysis

    assert [dataclasses.astuple(e) for e in analysis.ALL_GRAMMAR] == [
        dataclasses.astuple(e) for e in janalysis.ALL_GRAMMAR]
    assert analysis.MALFORMED_SPECS == janalysis.MALFORMED_SPECS
    assert analysis.grammar_specs(wire_only=True) == janalysis.grammar_specs(wire_only=True)


def test_malformed_specs_rejected():
    assert len(analysis.MALFORMED_SPECS) >= 20
    assert len({s for s, _ in analysis.MALFORMED_SPECS}) == len(analysis.MALFORMED_SPECS)
    for spec, fragment in analysis.MALFORMED_SPECS:
        with pytest.raises((ValueError, TypeError), match=fragment):
            dssfn.parse_spec(spec).validate(M)


def test_device_free_findings_equal_the_reference():
    """schedule, retrace and grammar-parse over ALL_GRAMMAR plus every
    malformed spec at M=8: the port's findings are repro's, as
    (check, subject) sets."""
    from repro.launch import lint_dssfn as jlint

    from repro_torch.launch import lint_dssfn

    argv = ["--checks", "schedule,retrace", "--all-grammar", "--num-workers", str(M)]
    for spec, _ in analysis.MALFORMED_SPECS:
        argv += ["--spec", spec]
    port = lint_dssfn.lint(lint_dssfn.parse_args(argv))
    ref = jlint.lint(jlint.parse_args(argv))
    assert _pairs(port) == _pairs(ref)
    assert {c for c, _ in _pairs(port)} == {"grammar-parse"}
    assert {s for _, s in _pairs(port)} == {s for s, _ in analysis.MALFORMED_SPECS}


# ---------------------------------------------------------------- mutations


def _mutation_pair(name):
    """(port findings, repro findings) of one seeded mutation."""
    import jax.numpy as jnp

    from repro import analysis as janalysis
    from repro.core import policy as jp
    from repro.core.topology import ExchangeSchedule as JSchedule

    if name == "leaky-policy":
        @dataclasses.dataclass(frozen=True)
        class JLeaky(jp.Gossip):
            hidden: int = dataclasses.field(default=1, compare=False)

        return (analysis.check_policy_cache_key(LeakyGossip(rounds=2), M, subject="l"),
                janalysis.check_policy_cache_key(JLeaky(rounds=2), M, subject="l"))
    if name == "raw-cholesky":
        return (analysis.lint_callable(torch.linalg.cholesky, torch.eye(6) * 2, subject="c"),
                janalysis.lint_jax_callable(jnp.linalg.cholesky, jnp.eye(6) * 2, subject="c"))
    if name == "half-accumulate":
        a, b = torch.zeros(4, 8), torch.zeros(8, 4)
        return (analysis.lint_callable(lambda a, b: a.bfloat16() @ b.bfloat16(), a, b,
                                       subject="h"),
                janalysis.lint_jax_callable(
                    lambda a, b: a.astype(jnp.bfloat16) @ b.astype(jnp.bfloat16),
                    jnp.zeros((4, 8)), jnp.zeros((8, 4)), subject="h"))
    if name == "inverse-closure":
        return (analysis.check_schedule(_directed(ExchangeSchedule), subject="d",
                                        expect_inverse_closed=True),
                janalysis.check_schedule(_directed(JSchedule), subject="d",
                                         expect_inverse_closed=True))
    if name == "weight-sum":
        kw = dict(num_workers=4, perms=_PERMS, weights=(0.7,), self_weight=0.5)
        return (analysis.check_schedule(ExchangeSchedule(**kw), subject="w"),
                janalysis.check_schedule(JSchedule(**kw), subject="w"))
    if name == "serve-collective":
        record = analysis.ProgramRecord([analysis.CallRecord(
            "c10d::allreduce_", ("f32",), ((8,),))])
        hlo = "\n".join([
            "ENTRY %main (p: f32[8]) -> f32[8] {",
            "  %p = f32[8]{0} parameter(0)",
            "  ROOT %ar = f32[8]{0} all-reduce(f32[8]{0} %p), "
            "replica_groups={{0,1,2,3}}, to_apply=%add",
            "}",
        ])
        return (analysis.check_serve_record({"program": record}, subject="s"),
                janalysis.check_serve_texts({"stablehlo": "", "hlo": hlo}, subject="s"))
    if name == "nondeterministic-seed":
        port = analysis.lint_source_text(
            "import time, torch\ntorch.manual_seed(int(time.time()))\n", filename="s.py")
        port += analysis.lint_source_text(_BAD_SOURCE.split("class P")[0], filename="s.py")
        ref = janalysis.lint_source_text(
            "import time, jax\njax.random.PRNGKey(int(time.time()))\n", filename="s.py")
        return port, ref
    assert name == "branch-in-mix"
    src = "class P:\n    def mix(self, x, state, ctx):\n        if x.sum() > 0:\n" \
          "            return x, state\n        return -x, state\n"
    return (analysis.lint_source_text(src, filename="m.py"),
            janalysis.lint_source_text(src, filename="m.py"))


MUTATIONS = {
    "leaky-policy": ["retrace-key-collision"],
    "raw-cholesky": ["numerics-cholesky"],
    "half-accumulate": ["numerics-accum"],
    "inverse-closure": ["schedule-inverse-closure"],
    "weight-sum": ["schedule-doubly-stochastic", "schedule-weight-sum"],
    "serve-collective": ["serve-collective"],
    "nondeterministic-seed": ["source-prng-seed"],
    "branch-in-mix": ["source-traced-branch"],
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_fires_the_reference_check(name):
    port, ref = _mutation_pair(name)
    assert _checks(port) == _checks(ref) == MUTATIONS[name]


# ---------------------------------------------------------------- CLI


def test_cli_clean_on_device_free_checks(tmp_path, capsys):
    from repro_torch.launch import lint_dssfn

    args = lint_dssfn.parse_args(
        ["--checks", "schedule,retrace,source", "--all-grammar"]
    )
    assert lint_dssfn.lint(args) == []

    out = tmp_path / "findings.json"
    rc = lint_dssfn.main([
        "--checks", "schedule,source", "--all-grammar",
        "--format", "json", "--out", str(out),
    ])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["count"] == 0 and payload["findings"] == []
    assert json.loads(capsys.readouterr().out)["errors"] == 0


def test_cli_reports_grammar_parse_failure():
    from repro_torch.launch import lint_dssfn

    rc = lint_dssfn.main(
        ["--spec", "bogus", "--checks", "schedule", "--format", "json"]
    )
    assert rc == 1


def test_cli_rejects_unknown_check():
    from repro_torch.launch import lint_dssfn

    with pytest.raises(SystemExit, match="unknown checks"):
        lint_dssfn.lint(lint_dssfn.parse_args(["--checks", "vibes"]))


def test_cli_device_defaults_to_cuda():
    from repro_torch.launch import lint_dssfn

    args = lint_dssfn.parse_args(["--checks", "serve"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lint_dssfn.lint(args)


def test_cli_without_host_mesh_warns_and_still_runs_numerics():
    from repro_torch.launch import lint_dssfn

    found = lint_dssfn.lint(lint_dssfn.parse_args(
        ["--checks", "wire,numerics", "--spec", "gossip:3:wire=bf16", "--spec", "exact",
         "--no-host-mesh", "--device", CPU]))
    assert [(f.check, f.severity) for f in found] == [("wire-environment", "warning")]


def test_dssfn_exports_analysis_surface():
    from repro import analysis as janalysis

    assert dssfn.parse_spec("exact") == ExactMean()
    for name in ("ALL_GRAMMAR", "check_wire_contract", "LintFinding"):
        assert hasattr(analysis, name)
    from repro_torch.core.backend import make_backend

    assert dssfn.make_backend is make_backend
    # Every reference name has its counterpart, or is mapped in the
    # package docstring.
    mapped = {"lint_jax_callable", "lint_stablehlo_text", "check_serve_texts"}
    for name in janalysis.__all__:
        assert name in analysis.__all__ or (name in mapped and name in analysis.__doc__), name


# ---------------------------------------------------------------- serve


def test_serve_surface_clean():
    assert analysis.check_serve_surface(buckets=(1, 4), device=CPU) == []


def test_serve_lint_fires_on_bf16_engine():
    engine = analysis.synthetic_serve_engine(
        dtype=torch.bfloat16, buckets=(1,), device=CPU
    )
    findings = analysis.check_serve_contract(engine, subject="serve:bf16")
    assert "numerics-accum" in {f.check for f in findings}


def test_synthetic_engine_serves_the_reference_weights():
    """The same default_rng numbers: logits equal repro's synthetic
    engine's within 1e-5 x max."""
    import jax.numpy as jnp
    import numpy as np

    from repro import analysis as janalysis

    for spec in analysis.serve.DEFAULT_FEATURE_SPECS:
        port = analysis.synthetic_serve_engine(features=spec, buckets=(4,), device=CPU)
        ref = janalysis.synthetic_serve_engine(features=spec, buckets=(4,))
        x = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
        got = port.forward(torch.from_numpy(x)).numpy()
        want = np.asarray(ref.forward(jnp.asarray(x)))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), spec


def test_serve_lint_fires_on_collective(monkeypatch):
    """Mutation: a bucket program whose record carries a c10d op, or
    whose run moved a transport, leaked SPMD machinery into the path."""
    record = analysis.ProgramRecord([analysis.CallRecord(
        "c10d::allreduce_", ("f32",), ((8,),))])
    findings = analysis.check_serve_record({"program": record}, subject="serve:mutated")
    assert [f.check for f in findings] == ["serve-collective"]
    assert findings[0].details["collective_counts"] == {"c10d::allreduce_": 1}

    from repro_torch.launch import mesh as mesh_lib

    group = mesh_lib.make_worker_group(1, device=CPU)
    engine = analysis.synthetic_serve_engine(buckets=(1,), device=CPU)
    body = engine._forward_program
    monkeypatch.setattr(engine, "_forward_program",
                        lambda x: group.transport.all_reduce(body(x)))
    found = analysis.check_serve_contract(engine, subject="serve:live")
    assert _checks(found) == ["serve-collective"]
    assert found[0].details["collective_counts"] == {"all-reduce": 1}


def test_serve_lint_probe_is_side_effect_free():
    engine = analysis.synthetic_serve_engine(buckets=(1, 4), device=CPU)
    x = torch.zeros((engine.request_dim, 1))
    engine.forward(x)                       # one real program
    before = engine.cache_info()
    findings = analysis.check_serve_contract(engine, subject="serve:purity")
    assert findings == []
    assert engine.cache_info() == before
    texts = engine.lowering_texts(bucket=4)
    assert engine.cache_info() == before
    assert texts["record"].count("\n") + 1 == len(texts["program"].calls)
    # Two layers through matmul_relu's plain version (the CPU's), then the
    # readout.
    assert texts["program"].counts()["matmul"] == 3
    with pytest.raises(ValueError, match="not in configured buckets"):
        engine.lowering_texts(bucket=3)


def test_serve_probe_purity_fires_when_the_probe_touches_the_cache(monkeypatch):
    engine = analysis.synthetic_serve_engine(buckets=(1,), device=CPU)
    real = engine.lowering_texts

    def polluting(**kw):
        engine._executable(kw["bucket"], torch.float32)
        return real(**kw)

    monkeypatch.setattr(engine, "lowering_texts", polluting)
    assert _checks(analysis.check_serve_contract(engine, subject="s")) == [
        "serve-probe-purity"]


def test_serve_check_registered_in_cli():
    from repro_torch.launch import lint_dssfn

    assert "serve" in lint_dssfn.CHECKS
    from repro.launch import lint_dssfn as jlint

    assert lint_dssfn.CHECKS == jlint.CHECKS
    args = lint_dssfn.parse_args(["--checks", "serve", "--spec", "exact", "--device", CPU])
    assert lint_dssfn.lint(args) == []
