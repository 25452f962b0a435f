"""The port's cost analysis (``launch/cost_analysis.py``) on the CPU: its
FLOPs against ``repro``'s HLO count (``hlo_analysis.analyze_module``) of
the same reduced programs, ``repro``'s ring formulas, a kernel launch
credited through the extended ``kernels/_record`` hook with its plain
version's work, the depth and length extrapolation against full traces,
and the live peak of a known sequence of ops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import hlo_analysis
from repro.models import build_model as j_build_model
from repro.models.steps import make_train_step as j_make_train_step
from repro.optim import AdamW as JAdamW
from repro_torch.analysis import numerics
from repro_torch.configs import get_config
from repro_torch.kernels import _record
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.gram.ref import gram_ref
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW

FLOPS_REL = 1e-3
B, S = 2, 64


def _reference_flops(arch, train):
    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if train:
        opt = JAdamW(lr=1e-4)
        fn = j_make_train_step(model, opt)
        args = (params, jax.eval_shape(opt.init, params), {"tokens": tokens, "labels": tokens})
    else:
        fn = model.forward
        args = (params, {"tokens": tokens})
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze_module(text).flops


def _meta_batch(train):
    t = torch.empty((B, S), dtype=torch.int32, device="meta")
    return {"tokens": t, "labels": t} if train else {"tokens": t}


@pytest.mark.parametrize("arch,train", [
    ("h2o_danube3_4b", False), ("zamba2_2_7b", False), ("xlstm_350m", False),
    ("phi35_moe_42b", False), ("h2o_danube3_4b", True)])
def test_flops_match_the_references_hlo_count(arch, train):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = dryrun._init_params(cfg)
    if train:
        opt = AdamW(lr=1e-4)
        _, a = ca.analyze_call(make_train_step(model, opt), params, opt.init(params),
                               _meta_batch(True))
    else:
        with torch.no_grad():
            _, a = ca.analyze_call(model.forward, params, _meta_batch(False))
    want = _reference_flops(arch, train)
    assert a.flops > 0
    assert abs(a.flops - want) <= FLOPS_REL * want, (a.flops, want)


def test_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config("musicgen_medium").reduced()
    model = build_model(cfg)
    params = dryrun._init_params(cfg)
    batch = {"tokens": torch.empty((B, S, cfg.num_codebooks), dtype=torch.int32, device="meta")}
    with torch.no_grad():
        _, a = ca.analyze_call(model.forward, params, batch)
        with FlopCounterMode(display=False) as counter:
            model.forward(params, batch)
    assert a.flops == counter.get_total_flops()


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("g", [1, 2, 16, 256])
def test_wire_bytes_are_the_references(op, g):
    for nbytes in (4, 4096, 12288 * 4096 * 2):
        assert ca._wire_bytes(op, nbytes, g) == hlo_analysis._wire_bytes(op, nbytes, g)
        mine = ca.CollectiveOp(op, "c", nbytes, g, 3)
        ref = hlo_analysis.CollectiveOp(op, "c", nbytes, g, 3)
        assert mine.wire_bytes == ref.wire_bytes


def test_analysis_sums_collectives_as_the_reference():
    ops = [("all-gather", 1024, 16, 2), ("all-reduce", 64, 256, 5), ("all-gather", 8, 2, 1)]
    mine = ca.ModuleAnalysis(collectives=[ca.CollectiveOp(o, "c", b, g, m) for o, b, g, m in ops])
    ref = hlo_analysis.ModuleAnalysis(
        collectives=[hlo_analysis.CollectiveOp(o, "c", b, g, m) for o, b, g, m in ops])
    assert mine.collective_wire_bytes == ref.collective_wire_bytes
    assert mine.collective_by_type() == ref.collective_by_type()
    assert mine.collective_counts() == ref.collective_counts()


def _launch(name, out, args, kwargs):
    """What a CUDA wrapper does after its launch: report it."""
    def call():
        result = torch.empty_like(out)
        _record.hook(name, torch.float32, result, (args, kwargs))
        return result
    return call


@pytest.mark.parametrize("case", ["gram", "flash_attention"])
def test_a_kernel_launch_is_credited_with_its_plain_versions_work(case):
    g = torch.Generator().manual_seed(0)
    if case == "gram":
        plain, args, kwargs = gram_ref, (torch.randn(3, 24, 40, generator=g),), {"mu": 0.1}
    else:
        q = torch.randn(1, 4, 32, 16, generator=g)
        kv = torch.randn(1, 2, 32, 16, generator=g)
        plain, args, kwargs = flash_attention_ref, (q, kv, kv.clone()), {"window": 8}
    want_out, want = ca.analyze_call(plain, *args, **kwargs)
    _, got = ca.analyze_call(_launch(case, want_out, args, kwargs))
    assert want.flops > 0
    assert got.flops == want.flops
    # The launch's bytes are its plain version's, beside its output's
    # bare allocation (which writes nothing).
    assert got.traffic_bytes == want.traffic_bytes
    assert got.by_op[f"kernel:{case}"].calls == 1
    assert got.by_op[f"kernel:{case}"].flops == want.flops
    # The credit allocates nothing: the peak is the output's.
    assert got.peak_live_bytes == want_out.numel() * want_out.element_size()


def test_kernel_hook_reaches_an_enclosing_numerics_recording():
    y = torch.randn(2, 8, 16)
    out = gram_ref(y, mu=1.0)
    with numerics.recording() as record:
        _, a = ca.analyze_call(_launch("gram", out, (y,), {"mu": 1.0}))
    assert [c.name for c in record.kernels()] == ["kernel:gram"]
    assert a.by_op["kernel:gram"].calls == 1
    assert _record.hook is None


def test_a_launch_without_inputs_is_refused():
    with pytest.raises(ValueError, match="no inputs"):
        ca.analyze_call(lambda: _record.hook("gram", torch.float32, torch.zeros(1)))
    assert _record.hook is None


def test_live_peak_of_a_known_sequence():
    a = torch.ones(100, 10)        # made before the call: not counted

    def program(x):
        b = x + 1                  # 4000 live
        c = b * 2                  # 8000
        del b                      # 4000
        d = c.t().contiguous()     # a view, then a copy: 8000
        e = torch.empty(500)       # 10000 (written: nothing)
        del c, e                   # 4000
        f = d.sum()                # 4004
        d.mul_(3)                  # in place: written, no new storage
        return d, f

    (d, f), got = ca.analyze_call(program, a)
    assert got.peak_live_bytes == 10000
    assert got.output_bytes == 4004
    assert got.traffic_bytes == 4000 * 4 + 4
    assert got.by_op["aten.t.default"].traffic_bytes == 0
    assert got.by_op["aten.mul_.Tensor"].traffic_bytes == 4000


def test_meta_repeats_are_the_ops_own_results():
    """The mode's cache of meta results gives what the op gives."""
    x = torch.empty(4, 6, device="meta").t()
    y = torch.empty(6, 1, device="meta")

    def ops():
        return [x * y, torch.cat([x, x], 1), x.sum(0, keepdim=True), torch.zeros(3, 2).t()]

    (first, again), a = ca.analyze_call(lambda: (ops(), ops()))
    for want, got in zip(ops(), first + again):
        assert (got.shape, got.stride(), got.dtype) == (want.shape, want.stride(), want.dtype)
    for want, got in zip(first + first, first + again):
        assert (got.shape, got.stride(), got.dtype) == (want.shape, want.stride(), want.dtype)
    assert a.by_op["aten.mul.Tensor"].calls == 2


@pytest.mark.parametrize("arch,shape_name,seq", [
    ("h2o_danube3_4b", "train_4k", S), ("phi35_moe_42b", "train_4k", S),
    ("zamba2_2_7b", "train_4k", S), ("zamba2_2_7b", "decode_32k", S),
    ("h2o_danube3_4b", "prefill_32k", S), ("xlstm_350m", "train_4k", 80)])
def test_extrapolation_equals_a_full_trace(arch, shape_name, seq):
    """A reduced config of four layer periods: the depth (and, for xLSTM,
    length) extrapolation against a full trace of it, FLOPs, bytes, the
    live peak and the results' bytes exactly.  xLSTM's train step runs
    at train_4k's batch a device on the 16x16 plan (256 / 16): at B=2
    and this width its optimizer phase, which does not grow with S, holds
    the peak at two and three chunks, and a line through them misses a
    longer step's peak."""
    base = get_config(arch).reduced()
    period = base.shared_attn_period or base.slstm_period or 1
    cfg = dataclasses.replace(base, num_layers=4 * period, remat=True)
    batch = 16 if cfg.family == "ssm" else B
    plan = make_production_mesh()
    rules = dryrun.layout_rules("2d", plan)
    got, traced = dryrun.trace_step(cfg, shape_name, batch, seq, rules, plan)
    want = dryrun._trace(cfg, shape_name, batch, seq, rules, plan)
    assert max(traced["layers"]) < cfg.num_layers
    assert max(traced["seqs"]) < seq or cfg.family != "ssm"
    assert got.flops == want.flops
    assert got.traffic_bytes == want.traffic_bytes
    assert got.output_bytes == want.output_bytes
    assert got.peak_live_bytes == want.peak_live_bytes
    assert {k: (v.calls, v.flops, v.traffic_bytes) for k, v in got.by_op.items()} == {
        k: (v.calls, v.flops, v.traffic_bytes) for k, v in want.by_op.items()}


def test_xlstm_prefill_extrapolation_equals_a_full_trace_at_full_width():
    """xLSTM-350M whole width at prefill_32k's batch a device (32 / 16),
    four periods and six chunks: the depth and length extrapolation
    against a full trace, every count and the live peak exactly.  (At the
    reduced width the prefill's peak moves between its sLSTM and mLSTM
    layers below four periods, so a line through two and three misses
    it; the planner plans the full width.)"""
    cfg = get_config("xlstm_350m")
    seq = 6 * cfg.ssm_chunk
    plan = make_production_mesh()
    rules = dryrun.layout_rules("2d", plan)
    got, traced = dryrun.trace_step(cfg, "prefill_32k", 2, seq, rules, plan)
    want = dryrun._trace(cfg, "prefill_32k", 2, seq, rules, plan)
    assert max(traced["layers"]) < cfg.num_layers and max(traced["seqs"]) < seq
    assert (got.flops, got.traffic_bytes, got.output_bytes, got.peak_live_bytes) == (
        want.flops, want.traffic_bytes, want.output_bytes, want.peak_live_bytes)
    assert {k: (v.calls, v.flops, v.traffic_bytes) for k, v in got.by_op.items()} == {
        k: (v.calls, v.flops, v.traffic_bytes) for k, v in want.by_op.items()}


def test_fit_is_exact_for_polynomials():
    """Linear counts (polynomials of degree one) extend exactly, to a whole
    number where the result is whole."""
    def trace(n):
        return ca.ModuleAnalysis(flops=3 * n + 5, traffic_bytes=7 * n + 2,
                                 collectives=[ca.CollectiveOp("all-reduce", "x", 8, 4, n + 1)],
                                 peak_live_bytes=11 * n, output_bytes=4,
                                 by_op={"op": ca.OpCost(n, 3 * n, 2 * n + 1)})

    got = ca.extrapolate(trace(2), trace(3), 2, 3, 40)
    want = trace(40)
    assert (got.flops, got.traffic_bytes, got.peak_live_bytes, got.output_bytes) == (
        want.flops, want.traffic_bytes, want.peak_live_bytes, want.output_bytes)
    assert all(type(v) is int for v in (got.flops, got.traffic_bytes, got.peak_live_bytes))
    assert got.collective_counts() == want.collective_counts()
    assert got.by_op == want.by_op
    lin = ca.extrapolate(trace(1), trace(2), 1, 2, 9)
    assert lin.flops == 32 and lin.collectives[0].multiplier == 10
