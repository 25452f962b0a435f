"""The retrace detector: cache-key completeness for policy values.

Port of ``repro/analysis/retrace.py``.  A backend records ONE program per
key (``ConsensusBackend.run``'s program record, the counterpart of the
reference's executable cache), and the key contains the policy VALUE —
so two policy objects must compare equal exactly when they run the same
program.  Both failure directions are bugs:

- a field missing from equality/hash (``compare=False``, a mutable
  default, an ``__eq__`` override) makes DISTINCT configurations collide
  onto one record entry (in the reference, one stale executable);
- an unhashable or identity-hashed field makes EQUAL configurations
  miss the record and count as a new program every call (two spellings
  of one value, ``LossyGossip(degree=2)`` and
  ``LossyGossip(topology=Ring(2))``, must be ONE entry).

The detector perturbs every policy / fault-model / topology field and
asserts, at the value level, that the variant is hashable, unequal to
the base, and that a reconstructed copy stays equal.  The program-level
check (:func:`check_backend_retrace`) then drives a real backend's
record through ``lowering_texts``, which runs the program once, and
reads only the normalized ``cache_info()`` schema that
``ConsensusBackend`` and ``ServeEngine`` share (``entries``,
``cache_hits``), never the backend's private state.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import policy as policy_lib
from repro_torch.core import topology as topology_lib

from .findings import LintFinding

#: The normalized cache_info schema (ConsensusBackend AND ServeEngine).
CACHE_INFO_KEYS = ("entries", "lowerings", "cache_hits", "keys")


def check_cache_info_schema(info: dict, *, subject: str) -> list[LintFinding]:
    findings: list[LintFinding] = []
    missing = [k for k in CACHE_INFO_KEYS if k not in info]
    if missing:
        findings.append(LintFinding(
            check="retrace-cache-schema",
            subject=subject,
            message=f"cache_info() is missing normalized keys {missing}",
            details={"present": sorted(info)},
        ))
        return findings
    if info["entries"] != len(info["keys"]):
        findings.append(LintFinding(
            check="retrace-cache-schema",
            subject=subject,
            message="cache_info() entries disagrees with len(keys)",
            details={"entries": info["entries"], "keys": len(info["keys"])},
        ))
    for k in ("entries", "lowerings", "cache_hits"):
        if not isinstance(info[k], int) or info[k] < 0:
            findings.append(LintFinding(
                check="retrace-cache-schema",
                subject=subject,
                message=f"cache_info()[{k!r}] is not a non-negative int",
                details={k: info[k]},
            ))
    return findings


def _topology_candidates(value):
    yield topology_lib.Hypercube()
    yield topology_lib.Ring(2)
    yield topology_lib.Ring(1)


def _candidates(name: str, value):
    """Plausible alternative values for one dataclass field."""
    if isinstance(value, bool):
        yield not value
    elif isinstance(value, int):
        yield value + 1
        if value > 1:
            yield value - 1
    elif isinstance(value, float):
        yield value * 2.0 + 0.125
        yield value / 2.0 + 0.0625
    elif isinstance(value, str):
        if name == "wire_dtype":
            yield "bfloat16" if value != "bfloat16" else "float16"
        elif name == "attack":
            yield "scale:3" if value != "scale:3" else "noise:0.5"
        else:
            yield value + "_alt"
    elif isinstance(value, tuple):
        yield value + (max(value, default=-1) + 1,)
        if value:
            yield value[:-1]
    elif isinstance(value, topology_lib.Topology):
        yield from (t for t in _topology_candidates(value) if t != value)
    elif isinstance(value, policy_lib.FaultModel):
        for _, cand in _fault_variants(value):
            yield cand
    elif value is None:
        if name == "topology":
            yield topology_lib.Ring(2)
        else:
            yield 3


def _fault_variants(faults):
    for f in dataclasses.fields(faults):
        for cand in _candidates(f.name, getattr(faults, f.name)):
            try:
                yield f.name, dataclasses.replace(faults, **{f.name: cand})
            except (ValueError, TypeError):
                continue


def perturb_policy(policy, num_workers: int):
    """One valid perturbed variant per field, as ``(field, variant)``;
    fields with no constructible valid alternative are skipped."""
    out = []
    for f in dataclasses.fields(policy):
        base_val = getattr(policy, f.name)
        for cand in _candidates(f.name, base_val):
            try:
                variant = dataclasses.replace(policy, **{f.name: cand})
                variant.validate(num_workers)
            except (ValueError, TypeError):
                continue
            out.append((f.name, variant))
            break
    return out


def check_policy_cache_key(
    policy, num_workers: int, *, subject: str
) -> list[LintFinding]:
    findings: list[LintFinding] = []
    try:
        base_hash = hash(policy)
    except TypeError as e:
        return [LintFinding(
            check="retrace-unhashable",
            subject=subject,
            message=(
                "policy is unhashable and cannot participate in the "
                "program key (every call would count as a new program)"
            ),
            details={"error": str(e)},
        )]

    # A reconstructed copy is the SAME value: must hit the same entry.
    clone = dataclasses.replace(policy)
    if clone != policy or hash(clone) != base_hash:
        findings.append(LintFinding(
            check="retrace-equality",
            subject=subject,
            message=(
                "dataclasses.replace() round-trip broke value equality "
                "— equal configurations would miss the program record"
            ),
            details={"clone_eq": clone == policy,
                     "hash_eq": hash(clone) == base_hash},
        ))

    for field_name, variant in perturb_policy(policy, num_workers):
        tag = f"{subject}.{field_name}"
        try:
            hash(variant)
        except TypeError as e:
            findings.append(LintFinding(
                check="retrace-unhashable",
                subject=tag,
                message=f"perturbing {field_name!r} made the policy unhashable",
                details={"error": str(e)},
            ))
            continue
        if variant == policy:
            findings.append(LintFinding(
                check="retrace-key-collision",
                subject=tag,
                message=(
                    f"distinct {field_name!r} values compare equal: both "
                    "configurations would share ONE program entry "
                    "(field missing from the policy's equality/hash)"
                ),
                details={"field": field_name,
                         "base": repr(getattr(policy, field_name)),
                         "variant": repr(getattr(variant, field_name))},
            ))
    return findings


def check_backend_retrace(
    backend, policy, num_workers: int, *, subject: str, device=None,
) -> list[LintFinding]:
    """Program-level confirmation on a real backend's record: equal
    values hit, perturbed values record new programs.  Each probe runs
    one mix of a (M, 4, 8) stack through ``lowering_texts`` on
    ``device`` (a mesh backend's own device; else default ``cuda``)."""
    import torch

    from repro_torch import prng
    from repro_torch._device import resolve_device

    findings: list[LintFinding] = []
    ctx = backend.ctx()
    group = getattr(backend, "group", None)
    dev = group.device if group is not None else resolve_device(device)
    x = backend.shard_workers(
        torch.from_numpy(prng.normal(prng.PRNGKey(0), (num_workers, 4, 8))).to(dev)
    )

    def probe(pol):
        def worker(x_m):
            out, _ = pol.mix(x_m, pol.init_state(x_m, ctx), ctx)
            return out.sum()
        backend.lowering_texts(
            worker, x, key="spmdlint-retrace", policy=pol,
        )

    # Record ENTRIES are the ground truth: a repeat never creates a new
    # entry and always bumps ``cache_hits``.
    info0 = backend.cache_info()
    probe(policy)
    probe(dataclasses.replace(policy))
    info = backend.cache_info()
    if (
        info["entries"] != info0["entries"] + 1
        or info["cache_hits"] <= info0["cache_hits"]
    ):
        findings.append(LintFinding(
            check="retrace-spurious",
            subject=subject,
            message=(
                "an equal policy value missed the program record "
                "(every call would count as a new program)"
            ),
            details={"new_entries": info["entries"] - info0["entries"],
                     "new_hits": info["cache_hits"] - info0["cache_hits"]},
        ))
    variants = perturb_policy(policy, num_workers)[:2]
    for field_name, variant in variants:
        before = backend.cache_info()["entries"]
        probe(variant)
        after = backend.cache_info()["entries"]
        if after != before + 1:
            findings.append(LintFinding(
                check="retrace-stale",
                subject=f"{subject}.{field_name}",
                message=(
                    f"perturbing {field_name!r} reused the base "
                    "program entry — one record for a distinct config"
                ),
                details={"new_entries": after - before},
            ))
    findings.extend(
        check_cache_info_schema(backend.cache_info(), subject=subject)
    )
    return findings
