"""The wire-budget check: collectives a program ran vs its declared eq.-15 wire.

Port of ``repro/analysis/wire.py``.  For each policy the checker runs the
production hot program — ``admm.worker_admm_iterations`` with
``trace_every=0`` — once on a :class:`~repro_torch.core.backend.MeshBackend`
whose W ranks hold one worker each (W = M, so every hop's rows cross the
wire, as every hop crosses devices in the reference's mesh), and compares
what the transport carried against what the policy declares:

- **wire-count**: the program must issue EXACTLY the policy's own
  exchanges — ``K_comm x hops`` collective-permutes for gossip schedules
  (``hops == Gossip.hops_for(M)`` for compressed ``H**B`` mixes, the
  serial round x edges product otherwise), ``K_comm`` all-reduces for
  the pmean-form policies, where ``K_comm = K // communication_interval``.
- **wire-hot-path**: ``trace_every=0`` admits zero NON-consensus
  collectives (no trace sums, no stray all-gathers) — any kind outside
  the expected set is a finding.
- **wire-payload**: every ``collective-permute`` payload must be in the
  dtype the policy's ``wire_bits`` declares (32 -> float32, 16 ->
  bfloat16 / float16), from the transport's tally by kind and payload
  dtype.  Policies whose ``wire_bits`` is a logical packed width over
  f32 lanes (``QuantizedGossip``) are exempt.
- **wire-declaration**: ``comm_scalars`` / ``wire_bytes`` must equal
  the closed form ``S x exchanges_for(M) x K_comm`` (and its
  ``wire_bits/8`` byte scaling) — a policy overriding one without the
  other is misdeclared.

The counts are the transport's own (``MeshBackend.collective_counts()``
and ``collective_bytes()``, through ``lowering_texts``), where the
reference counts ops in compiled HLO: the port lowers nothing.  A
:class:`~repro_torch.core.backend.SimulatedBackend`'s reductions are
local and carry nothing, so callers pass a mesh backend;
:func:`check_wire_specs` spawns the ranks once for a whole spec list.
"""
from __future__ import annotations

from repro_torch.core import policy as policy_lib
from repro_torch.core import topology as topology_lib

from .findings import LintFinding


def expected_mix_collectives(policy, num_workers: int) -> dict:
    """Collectives ONE communicating ``mix`` issues, derived from the
    policy's declared structure (never from the program)."""
    topo = getattr(policy, "topology", None)
    if topo is None:
        # ExactMean and the pmean forms of quantized/stale mixing.
        return {"all-reduce": 1}
    if isinstance(policy, policy_lib.Gossip):
        return {"collective-permute": policy.hops_for(num_workers)}
    phases = topo.cycle()
    per_phase = [
        len(topology_lib.cached_exchange_schedule(t, num_workers).perms)
        for t in phases
    ]
    if isinstance(policy, policy_lib.StaleMixing):
        # One schedule application per mix (validated single-phase).
        return {"collective-permute": per_phase[0]}
    rounds = getattr(policy, "rounds", 1)
    hops = sum(per_phase[b % len(per_phase)] for b in range(rounds))
    return {"collective-permute": hops}


def probe_iters(policy, num_iters: int) -> int:
    """K rounded up to a multiple of the communication interval (the
    local/communicate chunks require divisibility)."""
    interval = policy.communication_interval
    return interval * max(1, -(-num_iters // interval))


def hot_program_texts(
    backend, policy, *, num_iters: int, n: int = 16, q: int = 3,
    j_per: int = 8, device=None,
) -> dict:
    """Run the ``trace_every=0`` ADMM worker program under ``policy``
    once and return the backend's ``lowering_texts``: the call record
    and the collectives this rank's transport carried.  The data lie on
    a mesh backend's device, else on ``device`` (default ``cuda``)."""
    import torch

    from repro_torch import prng
    from repro_torch._device import resolve_device
    from repro_torch.core import admm

    group = getattr(backend, "group", None)
    dev = group.device if group is not None else resolve_device(device)
    m = backend.num_workers
    ky, kt = prng.split(prng.PRNGKey(0))
    yw = torch.from_numpy(prng.normal(ky, (m, n, j_per))).to(dev)
    tw = torch.from_numpy(prng.normal(kt, (m, q, j_per))).to(dev)
    z0 = torch.zeros((q, n), device=dev)

    def worker(y_m, t_m, z0r):
        a, chol, _ = admm._worker_stats(y_m, t_m, 1e-2)
        return admm.worker_admm_iterations(
            backend, a, chol, y_m, t_m, z0r, mu=1e-2, eps_radius=6.0,
            num_iters=num_iters, policy=policy, trace_every=0,
        )

    return backend.lowering_texts(
        worker, backend.shard_workers(yw), backend.shard_workers(tw),
        replicated=(z0,), key=("spmdlint-wire", policy, num_iters), policy=policy,
    )


_WIDTH_DTYPES = {32: ("float32",), 16: ("bfloat16", "float16")}


def check_wire_contract(
    policy, backend, *, num_iters: int = 8, subject: str, texts=None,
) -> list[LintFinding]:
    m = backend.num_workers
    findings: list[LintFinding] = []
    k = probe_iters(policy, num_iters)
    k_comm = k // policy.communication_interval
    if texts is None:
        texts = hot_program_texts(backend, policy, num_iters=k)

    per_mix = expected_mix_collectives(policy, m)
    expected = {op: c * k_comm for op, c in per_mix.items()}
    counts = texts["collective_counts"]

    extra_ops = sorted(set(counts) - set(expected))
    if extra_ops:
        findings.append(LintFinding(
            check="wire-hot-path",
            subject=subject,
            message=(
                "trace_every=0 program issued collectives outside the "
                f"policy's own exchanges: {extra_ops}"
            ),
            details={"counts": counts, "expected_ops": sorted(expected)},
        ))
    mismatched = {
        op: (counts.get(op, 0), want)
        for op, want in expected.items()
        if counts.get(op, 0) != want
    }
    if mismatched:
        findings.append(LintFinding(
            check="wire-count",
            subject=subject,
            message=(
                "collective counts disagree with the declared schedule "
                "structure (measured, expected) per op"
            ),
            details={
                "mismatched": mismatched, "counts": counts,
                "expected": expected, "num_iters": k,
                "communicating_iters": k_comm, "num_workers": m,
            },
        ))

    # ---- payload width (the transport's tally by payload dtype) ------
    quantized = isinstance(policy, policy_lib.QuantizedGossip)
    if expected.get("collective-permute"):
        payloads = texts["collective_dtypes"].get("collective-permute", {})
        widths = _WIDTH_DTYPES.get(policy.wire_bits)
        if quantized or widths is None:
            # Logical packed bits over f32 lanes: physical width is not
            # wire_bits/8 by design; nothing to check, note it instead.
            widths = ("float32",)
        bad = {dtype: n for dtype, n in payloads.items() if dtype not in widths}
        if bad:
            findings.append(LintFinding(
                check="wire-payload",
                subject=subject,
                message=(
                    f"collective-permute payload dtype disagrees with "
                    f"declared wire_bits={policy.wire_bits} "
                    f"(expected one of {widths})"
                ),
                details={"bad_payloads": sorted(bad.items()),
                         "declared_wire_bits": policy.wire_bits,
                         "logical_packing": quantized},
            ))

    # ---- declaration arithmetic (no program needed) ------------------
    s = 64  # any per-exchange scalar count exercises the closed form
    declared = policy.comm_scalars(
        scalars=s, num_consensus=k, num_workers=m
    )
    closed_form = s * policy.exchanges_for(m) * k_comm
    if declared != closed_form:
        findings.append(LintFinding(
            check="wire-declaration",
            subject=subject,
            message=(
                "comm_scalars disagrees with "
                "scalars x exchanges_for(M) x (K / interval)"
            ),
            details={"declared": declared, "closed_form": closed_form,
                     "exchanges_for": policy.exchanges_for(m),
                     "interval": policy.communication_interval},
        ))
    declared_bytes = policy.wire_bytes(
        scalars=s, num_consensus=k, num_workers=m
    )
    if declared_bytes * 8 != declared * policy.wire_bits:
        findings.append(LintFinding(
            check="wire-declaration",
            subject=subject,
            message="wire_bytes disagrees with comm_scalars x wire_bits / 8",
            details={"declared_bytes": declared_bytes,
                     "comm_scalars": declared,
                     "wire_bits": policy.wire_bits},
        ))
    return findings


def _probe_rank(group, specs, num_iters) -> dict:
    """One rank of :func:`check_wire_specs`: every spec's hot program on
    this rank's worker, its transport's numbers and its wire findings."""
    from repro_torch import dssfn
    from repro_torch.core.backend import MeshBackend

    out = {}
    for spec in specs:
        policy = dssfn.parse_spec(spec)
        backend = MeshBackend(group, policy=policy)
        texts = hot_program_texts(
            backend, policy, num_iters=probe_iters(policy, num_iters),
        )
        out[spec] = {
            "collective_counts": texts["collective_counts"],
            "collective_bytes": texts["collective_bytes"],
            "collective_dtypes": texts["collective_dtypes"],
            "findings": check_wire_contract(
                policy, backend, num_iters=num_iters, subject=spec, texts=texts,
            ),
        }
    return out


def check_wire_specs(
    specs, *, num_workers: int = 8, num_iters: int = 8, device=None,
    threads: int | None = None,
) -> list[LintFinding]:
    """:func:`check_wire_contract` for every spec, on one group of
    ``num_workers`` gloo ranks, one worker a rank, spawned once for the
    whole list (on the card the ranks share it, host-staged); a finding
    any rank reports is reported once."""
    from repro_torch._device import resolve_device
    from repro_torch.launch.mesh import spawn_workers

    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        # One build before the ranks start, not one nvcc per rank.
        _build.build_all(["gram"])
    per_rank = spawn_workers(
        _probe_rank, num_workers, list(specs), num_iters,
        num_workers=num_workers, backend="gloo", device=dev, threads=threads,
    )
    seen, findings = set(), []
    for rank in per_rank:
        for spec in specs:
            for f in rank[spec]["findings"]:
                if (f.check, f.subject, f.message) not in seen:
                    seen.add((f.check, f.subject, f.message))
                    findings.append(f)
    return findings
