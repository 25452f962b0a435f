"""The port's wire check on a gloo mesh of CPU ranks, against repro's
wire model.

One group of 8 ranks (one worker a rank, so every hop's rows cross the
wire) is spawned once for the module, and runs ``repro``'s hot program
(``worker_admm_iterations`` with ``trace_every=0``, n=16, q=3, j_per=8)
for each of the 25 ``wire_check`` entries of ``ALL_GRAMMAR`` at K=8, plus
three mutated policies.  For each entry and each rank: the transport's
counts equal ``repro.analysis.expected_mix_collectives(...) x K_comm``
exactly, no other kinds appear, the permute payloads are in the dtype
``wire_bits`` declares (bf16 for ``wire=bf16``, f16 for ``wire=f16``),
and ``check_wire_contract`` finds nothing.  The mutations fire
``wire-hot-path``, ``wire-count`` and ``wire-payload``.  The CLI's own
``--checks wire,numerics --device cpu`` run spawns its group once more.
"""
import dataclasses

import pytest

from repro_torch import analysis, dssfn
from repro_torch.core.policy import ExactMean, Gossip
from repro_torch.launch import mesh as mesh_lib

M, K = 8, 8
SPECS = analysis.grammar_specs(wire_only=True)


@dataclasses.dataclass(frozen=True)
class ChattyExact(ExactMean):
    """Mutation: a mix that also takes a max over the workers (a second
    all-reduce a mix)."""

    def mix(self, x, state, ctx):
        out, state = super().mix(x, state, ctx)
        return out + 0.0 * ctx.pmax(x), state


@dataclasses.dataclass(frozen=True)
class GatheringGossip(Gossip):
    """Mutation: a gossip mix that gathers every worker's value (a
    collective kind outside the policy's own exchanges)."""

    def mix(self, x, state, ctx):
        out, state = super().mix(x, state, ctx)
        full = ctx.transport.all_gather(x) if hasattr(ctx, "transport") else x
        return out + 0.0 * full.sum(), state


@dataclasses.dataclass(frozen=True)
class WideWire(Gossip):
    """Mutation: declares a bf16 wire (16 bits) and sends f32."""

    def mix(self, x, state, ctx):
        return Gossip(rounds=self.rounds, topology=self.topology).mix(x, state, ctx)


MUTANTS = {
    "chatty-exact": (ChattyExact(), ["wire-count"]),
    "gathering-gossip": (GatheringGossip(rounds=2), ["wire-hot-path"]),
    "wide-wire": (WideWire(rounds=2, wire_dtype="bfloat16"), ["wire-payload"]),
}


def _rank(group, specs, mutants):
    """Every grammar entry through the port's own probe, then the
    mutants' hot programs and findings on this rank."""
    from repro_torch.core.backend import MeshBackend

    out = analysis.wire._probe_rank(group, specs, K)
    for name, (policy, _) in mutants.items():
        backend = MeshBackend(group, policy=policy)
        texts = analysis.hot_program_texts(backend, policy, num_iters=K)
        out[name] = {
            "collective_counts": texts["collective_counts"],
            "findings": analysis.check_wire_contract(
                policy, backend, num_iters=K, subject=name, texts=texts),
        }
    return out


@pytest.fixture(scope="module")
def probe():
    return mesh_lib.spawn_workers(
        _rank, M, SPECS, MUTANTS, num_workers=M, backend="gloo", device="cpu",
        threads=1, join_timeout_s=600,
    )


def test_the_probe_covers_every_wire_entry():
    assert len(SPECS) == 25


@pytest.mark.parametrize("spec", SPECS)
def test_wire_counts_equal_the_reference_model(probe, spec):
    from repro import analysis as janalysis
    from repro import dssfn as jdssfn

    policy = dssfn.parse_spec(spec)
    k = analysis.wire.probe_iters(policy, K)
    k_comm = k // policy.communication_interval
    want = {op: c * k_comm for op, c in
            janalysis.expected_mix_collectives(jdssfn.parse_spec(spec), M).items()}
    # The quantizer's wire_bits count packed bits over f32 lanes.
    narrow = policy.wire_bits == 16
    widths = {policy.wire_dtype} if narrow else {"float32"}
    for rank in probe:
        got = rank[spec]
        assert got["collective_counts"] == want, (spec, got["collective_counts"], want)
        assert set(got["collective_bytes"]) == set(want)
        for kind, n in want.items():
            assert got["collective_dtypes"][kind] == {next(iter(widths)): n}, (spec, got)
        assert got["findings"] == [], (spec, got["findings"])


def test_narrow_wires_carry_their_dtype(probe):
    for spec, dtype in (("gossip:3:wire=bf16", "bfloat16"), ("gossip:2:wire=f16", "float16")):
        for rank in probe:
            assert set(rank[spec]["collective_dtypes"]["collective-permute"]) == {dtype}


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_wire_mutations_fire(probe, name):
    want = MUTANTS[name][1]
    for rank in probe:
        assert sorted({f.check for f in rank[name]["findings"]}) == want, (
            name, rank[name])


def test_cli_wire_and_numerics_exit_zero(tmp_path):
    import json

    from repro_torch.launch import lint_dssfn

    out = tmp_path / "wire.json"
    rc = lint_dssfn.main(["--all-grammar", "--checks", "wire,numerics", "--device", "cpu",
                          "--format", "json", "--out", str(out)])
    assert rc == 0
    assert json.loads(out.read_text())["count"] == 0
