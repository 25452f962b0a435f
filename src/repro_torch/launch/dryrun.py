"""Dry run of the model zoo on the production meshes: for every (arch x
input shape), size one device's share of the step on a plan of 256 or 512
H100s, with no device and no allocation.

    python -m repro_torch.launch.dryrun --shape train_4k
    python -m repro_torch.launch.dryrun --arch zamba2_2_7b --both-meshes --layout fsdp

Port of ``repro/launch/dryrun.py``, which lowers and compiles each step
for a mesh of 512 placeholder devices and reads the compiled program.  The
port lowers nothing.  For each combination it:

- builds the full model's params under ``FakeTensorMode`` (shapes and
  dtypes, no storage), the ``AdamW`` state, caches and batch, and their
  spec trees for the layout's ``AxisRules`` (``launch/specs.py``), as
  ``repro`` builds them; ``memory.argument_bytes`` is what one device
  holds of them;
- traces the step (``make_train_step``, ``make_prefill_step`` or
  ``make_serve_step``) under ``launch/cost_analysis.py`` on ``meta``
  twins of the tensors (the same ops at a fraction of a fake tensor's
  cost).  The trace is one device's share of the program: the batch cut
  to B / (the data axes' size) where ``_bspec`` shards it, and each
  product with a ``"T"``-sharded weight counted at 1/model of its FLOPs
  and bytes (a product whose operand is such a weight, or, in the
  backward pass, the math of an autograd node whose input leads to such
  a weight through views and casts: its gradient).
  Nothing else is split across the model axis: activations, the ops
  that are not products (so their bytes) and attention's own products
  count whole on every device.  Under a tensor-parallel plan (a
  ``"T"``-sharded weight and a model axis of more than one device)
  ``temp_bytes``, ``peak_bytes_per_device``, ``flops_per_device``,
  ``hbm_bytes_per_device``, ``compute_s`` and ``memory_s`` are
  therefore upper bounds of a device's share (``useful_flops_ratio`` a
  lower bound), and ``cost.upper_bounds`` names them; on a plan with no
  tensor parallelism they are the program's own and it is empty;
- traces a config cut to two layer periods and to three
  (``dataclasses.replace(cfg, num_layers=...)``) and extends every count
  linearly to the full depth (``cost_analysis.extrapolate``, the
  counterpart of ``repro``'s loop trip counts).  For xLSTM, whose sLSTM
  loop runs one step at a time, it also traces two lengths a chunk apart
  and extends in S.  A train step's optimizer update holds every gradient
  beside the update's temporaries, a peak that grows faster with depth
  than the forward and backward pass's, so that phase is sized at full
  depth on its own and the peak is the larger of the two;
- models the collectives from the plan, since there is no GSPMD to read
  them from (a deliberate difference):

  * every ``"F"``-sharded leaf is all-gathered over its F axes once in the
    forward pass, and once more in the backward pass of a train step;
  * every ``"F"``-sharded leaf's gradient is reduce-scattered once;
  * in a train step whose batch is sharded, every other leaf's gradient
    is all-reduced over the data axes once (data parallelism);
  * each attention block, FFN or expert FFN, Mamba2, mLSTM and sLSTM block
    with ``"T"``-sharded weights all-reduces its (B_local, S, d) output
    over the model axis once in the forward pass and once more in the
    backward pass;

- writes ``repro``'s result keys: ``status``, ``layout``,
  ``lower_compile_s`` (here the seconds of building and tracing),
  ``memory`` (argument, output and temp bytes, ``peak_bytes_per_device``
  = argument + temp, where temp is the trace's live peak, results
  included), ``cost``, ``collectives`` and ``roofline`` (``dominant``,
  ``model_flops_per_device``, ``useful_flops_ratio``), over the H100
  figures of ``launch/mesh.HARDWARE``: the collective term at NVLink's
  rate inside a node of 8 and InfiniBand's for a group that spans more.

``long_500k`` on a full-attention arch is ``SKIP(full-attention)``, as in
``repro``.  ``--save-trace PATH`` writes the per-op breakdown where
``repro``'s ``--save-hlo`` writes the HLO text.  Results go to
``experiments/dryrun_torch`` by default.  ``cost`` has no
``xla_cost_analysis_*`` counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.cost_analysis import CollectiveOp, analyze_call, extrapolate
from repro_torch.launch.mesh import (HARDWARE, MeshPlan, data_axes_for, link_bandwidth,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.steps import (global_norm, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.optim import AdamW
from repro_torch.sharding.rules import PARAM_RULES, AxisRules

LAYOUTS = ("2d", "fsdp", "tp2d")
#: What a tensor-parallel plan overstates: activations and every op that
#: is not a product with a T-sharded weight count whole on each device.
UPPER_BOUNDS = ("memory.temp_bytes", "memory.peak_bytes_per_device", "cost.flops_per_device",
                "cost.hbm_bytes_per_device", "roofline.compute_s", "roofline.memory_s")


def roofline_terms(flops, hbm_bytes, collectives) -> dict:
    """Seconds of compute, HBM traffic and collectives at the H100's
    rates; each collective at its group's link rate."""
    return {
        "compute_s": flops / HARDWARE["peak_flops_bf16"],
        "memory_s": hbm_bytes / HARDWARE["hbm_bandwidth"],
        "collective_s": sum(c.wire_bytes / link_bandwidth(c.group_size) for c in collectives),
    }


def model_flops_per_device(cfg: ModelConfig, shape_name: str, num_devices: int, *,
                           batch: int | None = None, seq: int | None = None) -> float:
    info = specs_lib.INPUT_SHAPES[shape_name]
    b, s = batch or info["batch"], seq or info["seq"]
    tokens = b * (s if info["kind"] != "decode" else 1)
    n_active = cfg.active_param_count()
    mult = 6.0 if info["kind"] == "train" else 2.0
    return mult * n_active * tokens / num_devices


def layout_rules(layout: str, plan: MeshPlan, fsdp: bool = True) -> AxisRules:
    if layout == "2d":
        # Baseline: batch/FSDP over ("pod","data"), tensor over "model".
        return AxisRules(mesh=plan, data_axes=data_axes_for(plan), model_axis="model",
                         fsdp=fsdp)
    if layout == "fsdp":
        # Pure data-parallel + FSDP over ALL mesh axes, no tensor parallelism.
        return AxisRules(mesh=plan, data_axes=data_axes_for(plan) + ("model",),
                         model_axis=None, fsdp=fsdp)
    if layout == "tp2d":
        # Weight-stationary 2-D TP (decode): batch replicated, weights 2-D
        # sharded over (data x model).
        return AxisRules(mesh=plan, data_axes=(), fsdp_axes=data_axes_for(plan),
                         model_axis="model", fsdp=True)
    raise ValueError(f"unknown layout {layout!r}")


# ------------------------------------------------------------------ trees

def _on_meta(tree):
    return specs_lib.tree_map_with_path(
        lambda _, t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta"),
        tree)


def _init_params(cfg: ModelConfig):
    """The seeded init's parameter shapes and dtypes as ``meta`` tensors
    (built under ``FakeTensorMode``: ``init`` draws from a generator)."""
    with FakeTensorMode():
        fake = build_model(cfg).init(torch.Generator().manual_seed(0))
    return _on_meta(fake)


def _leaf_tags(path, leaf, spec) -> list:
    """``(tag, axes)`` of each dim a rule shards: tag "F" or "T"."""
    rule = PARAM_RULES.get(specs_lib._leaf_name(path))
    if rule is None or not spec:
        return []
    lead = leaf.ndim - len(rule)
    return [(tag, spec[lead + i]) for i, tag in enumerate(rule)
            if tag is not None and spec[lead + i] is not None]


def _split(tags, plan: MeshPlan, tag: str) -> int:
    out = 1
    for t, axes in tags:
        if t == tag:
            out *= specs_lib.axis_count(axes, plan)
    return out


def _tensor_parallel(params, pspec, rules: AxisRules, plan: MeshPlan):
    """``product_scale`` for the cost analysis: 1/model for a product with
    a ``"T"``-sharded weight (an operand shares its storage, or the
    product is the backward math of an autograd node one of whose inputs
    leads to the weight through single-input nodes such as views and
    casts: a gradient of the weight or through it), else None where no
    weight is so sharded or the model axis is one device."""
    keys = set()
    for path, leaf in specs_lib.leaves_with_path(params):
        if any(t == "T" for t, _ in _leaf_tags(path, leaf, specs_lib.lookup(pspec, path))):
            keys.add(leaf.untyped_storage()._cdata)
    if not keys or plan.axis_sizes[rules.model_axis] == 1:
        return None
    share = 1.0 / plan.axis_sizes[rules.model_axis]

    def reaches_weight(node) -> bool:
        for fn, _ in node.next_functions:
            while fn is not None:
                var = getattr(fn, "variable", None)       # an AccumulateGrad
                if var is not None:
                    if var.untyped_storage()._cdata in keys:
                        return True
                    break
                if len(fn.next_functions) != 1:
                    break
                fn = fn.next_functions[0][0]
        return False

    def scale(func, args, out):
        for a in args:
            if isinstance(a, torch.Tensor) and a.untyped_storage()._cdata in keys:
                return share
        # Backward math runs with grad mode off (a remat recompute, also
        # under a node, runs with it on and is forward math).
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled() and reaches_weight(node):
            return share
        return 1

    return scale


# ----------------------------------------------------------------- blocks

def _blocks(cfg: ModelConfig, params) -> list:
    """``(path, applications)`` of the blocks whose outputs a tensor-
    parallel layout all-reduces, per step."""
    if cfg.family == "hybrid":
        periods = cfg.num_layers // cfg.shared_attn_period
        return [(("mamba",), cfg.num_layers), (("shared_attn", "attn"), periods),
                (("shared_attn", "ffn"), periods)]
    if cfg.family == "ssm":
        periods = cfg.num_layers // cfg.slstm_period
        return [(("mlstm",), cfg.num_layers - periods), (("slstm",), periods)]
    out = [(("layers", "attn"), cfg.num_layers)]
    if "ffn" in params["layers"]:
        out.append((("layers", "ffn"), cfg.num_layers))
    return out


def plan_collectives(cfg: ModelConfig, kind: str, params, pspec, rules: AxisRules,
                     plan: MeshPlan, batch: int, b_local: int, seq: int) -> list:
    """The collectives of one step on ``plan``, from the spec trees (see
    the module docstring for the model)."""
    train = kind == "train"
    passes = 2 if train else 1
    bspec = specs_lib._bspec(batch, rules, plan)
    data = specs_lib.axis_count(bspec, plan)
    out = []
    for path, leaf in specs_lib.leaves_with_path(params):
        tags = _leaf_tags(path, leaf, specs_lib.lookup(pspec, path))
        name = "/".join(map(str, path))
        nbytes = leaf.numel() * leaf.element_size()
        fsplit, tsplit = _split(tags, plan, "F"), _split(tags, plan, "T")
        if fsplit > 1:
            out.append(CollectiveOp("all-gather", f"fsdp:{name}", nbytes // tsplit, fsplit,
                                    passes))
            if train:
                out.append(CollectiveOp("reduce-scatter", f"fsdp-grad:{name}",
                                        nbytes // (tsplit * fsplit), fsplit))
        elif train and data > 1:
            out.append(CollectiveOp("all-reduce", f"dp-grad:{name}", nbytes // tsplit, data))
    model = plan.axis_sizes.get(rules.model_axis, 1) if rules.model_axis else 1
    tokens = b_local * (1 if kind == "decode" else seq)
    act = tokens * cfg.d_model * cfg.torch_dtype.itemsize
    for path, applications in _blocks(cfg, params):
        block = specs_lib.leaves_with_path(specs_lib.lookup(params, path), path)
        if model > 1 and any(t == "T" for p, leaf in block
                             for t, _ in _leaf_tags(p, leaf, specs_lib.lookup(pspec, p))):
            out.append(CollectiveOp("all-reduce", "tensor:" + "/".join(path), act, model,
                                    applications * passes))
    return out


# ------------------------------------------------------------------ trace

def _period(cfg: ModelConfig) -> int:
    return cfg.shared_attn_period or cfg.slstm_period or 1


#: xLSTM's longer full-sequence steps are traced at these many chunks and
#: extended in S: FLOPs, bytes and calls grow linearly in S, and at the
#: full width the live peak does too from two chunks on.
XLSTM_CHUNKS = (2, 3)


def _trace(cfg: ModelConfig, shape_name: str, b_local: int, seq: int, rules: AxisRules,
           plan: MeshPlan):
    """One device's share of the step of ``cfg`` (the cost analysis)."""
    info = specs_lib.INPUT_SHAPES[shape_name]
    model = build_model(cfg)
    params = _init_params(cfg)
    pspec = specs_lib.param_spec_tree(params, rules, plan)
    scale = _tensor_parallel(params, pspec, rules, plan)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in specs_lib.batch_specs(cfg, shape_name, batch=b_local, seq=seq).items()}
    if info["kind"] == "train":
        opt = AdamW(lr=1e-4)
        _, a = analyze_call(make_train_step(model, opt), params, opt.init(params), batch,
                            product_scale=scale)
        return a
    with torch.no_grad():
        if info["kind"] == "prefill":
            _, a = analyze_call(make_prefill_step(model), params, batch, product_scale=scale)
        else:
            cache = model.init_cache(b_local, seq, device="meta")
            _, a = analyze_call(make_serve_step(model), params, batch, cache,
                                product_scale=scale)
    return a


def trace_step(cfg: ModelConfig, shape_name: str, b_local: int, seq: int, rules: AxisRules,
               plan: MeshPlan):
    """The cost analysis of the full step from traces of the config cut in
    depth (and, for xLSTM's full-sequence steps, in length), extended to
    the full config.  Returns ``(analysis, traced)``.

    Depth: two and three layer periods, extended linearly.  (One period
    would do for FLOPs and bytes, but the first period's transients meet
    no earlier period's, so a line through one and two misses the live
    peak of deeper steps.)  xLSTM runs its sLSTM layer one step at a time
    and its mLSTM one chunk at a time, so a full-length trace costs time
    in S: its full-sequence steps longer than ``XLSTM_CHUNKS`` chunks are
    traced at those lengths as well, and extended linearly in S.

    FLOPs, bytes, calls and collectives are exact.  The live peak is
    exact where the traces peak in the phase that the full step peaks in
    (as the tests hold for the zoo); at a small width, batch or length
    another phase can hold a cut's peak, and the line then misses."""
    period = _period(cfg)
    periods = cfg.num_layers // period
    decode = specs_lib.INPUT_SHAPES[shape_name]["kind"] == "decode"
    seqs = [seq]
    if cfg.family == "ssm" and not decode and seq > XLSTM_CHUNKS[-1] * cfg.ssm_chunk:
        if seq % cfg.ssm_chunk:
            raise ValueError(f"xLSTM's S={seq} is not a multiple of its chunk {cfg.ssm_chunk}")
        seqs = [k * cfg.ssm_chunk for k in XLSTM_CHUNKS]
    counts = [2, 3] if periods > 3 else [periods]
    by_seq = []
    for s in seqs:
        traces = [_trace(dataclasses.replace(cfg, num_layers=n * period), shape_name, b_local, s,
                         rules, plan) for n in counts]
        by_seq.append(extrapolate(*traces, *counts, periods) if len(traces) > 1 else traces[0])
    full = extrapolate(*by_seq, *seqs, seq) if len(by_seq) > 1 else by_seq[0]
    return full, {"layers": [n * period for n in counts], "seqs": seqs}


def _update_peak(params) -> float:
    """Live bytes of a train step's optimizer phase at full depth: every
    gradient (made before it) and the update's own temporaries."""
    grads = specs_lib.tree_map_with_path(lambda _, t: torch.empty_like(t), params)
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    _, a = analyze_call(lambda: (global_norm(grads), opt.update(params, grads, state)))
    return sum(g.numel() * g.element_size() for _, g in specs_lib.leaves_with_path(grads)) \
        + a.peak_live_bytes


# ------------------------------------------------------------ entry points

def dryrun_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    overrides: dict | None = None,
    fsdp: bool = True,
    layout: str = "2d",
    save_trace: str | None = None,
    plan: MeshPlan | None = None,
    batch: int | None = None,
    seq: int | None = None,
) -> dict:
    """One combination's result.  ``plan`` replaces the production mesh
    (for example a 1x1 plan of one card), and ``batch``/``seq`` the
    shape's global batch and length."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    info = dict(specs_lib.INPUT_SHAPES[shape_name])
    info.update({k: v for k, v in (("batch", batch), ("seq", seq)) if v})
    plan = plan or make_production_mesh(multi_pod=multi_pod)
    result = {
        "arch": arch, "shape": shape_name, "mesh": plan.name,
        "kind": info["kind"], "status": "OK",
    }
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        result["status"] = "SKIP(full-attention)"
        return result

    t0 = time.perf_counter()
    rules = layout_rules(layout, plan, fsdp)
    result["layout"] = layout
    model = build_model(cfg)
    b, s = info["batch"], info["seq"]
    params = _init_params(cfg)
    pspec = specs_lib.param_spec_tree(params, rules, plan)
    batch_shapes = specs_lib.batch_specs(cfg, shape_name, batch=b, seq=s)
    bspec = specs_lib.batch_spec_tree(batch_shapes, rules, plan, b)
    by_tree = {"params": specs_lib.per_device_bytes(params, pspec, plan),
               "batch": specs_lib.per_device_bytes(batch_shapes, bspec, plan)}
    if info["kind"] == "train":
        state = AdamW(lr=1e-4).init(params)
        ospec = specs_lib.opt_state_spec_tree(state, pspec)
        by_tree["opt_state"] = specs_lib.per_device_bytes(state, ospec, plan)
    elif info["kind"] == "decode":
        cache = model.init_cache(b, s, device="meta")
        cspec = specs_lib.cache_spec_tree(cache, cfg, b, rules, plan)
        by_tree["cache"] = specs_lib.per_device_bytes(cache, cspec, plan)
    arg = sum(by_tree.values())
    b_local = b // specs_lib.axis_count(specs_lib._bspec(b, rules, plan), plan)
    analysis, traced = trace_step(cfg, shape_name, b_local, s, rules, plan)
    temp = analysis.peak_live_bytes
    if info["kind"] == "train":
        temp = max(temp, _update_peak(params))
    analysis.collectives = plan_collectives(cfg, info["kind"], params, pspec, rules, plan, b,
                                            b_local, s)
    result["lower_compile_s"] = round(time.perf_counter() - t0, 1)

    result["memory"] = {
        "argument_bytes": arg,
        "output_bytes": analysis.output_bytes,
        "temp_bytes": temp,
        "peak_bytes_per_device": arg + temp,
        "argument_bytes_by_tree": by_tree,
    }
    flops, hbm_bytes, wire = (analysis.flops, analysis.traffic_bytes,
                              analysis.collective_wire_bytes)
    result["cost"] = {
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm_bytes,
        "batch_per_device": b_local,
        "traced": traced,
        "upper_bounds": list(UPPER_BOUNDS) if _tensor_parallel(params, pspec, rules, plan)
        else [],
    }
    result["collectives"] = {
        "wire_bytes_per_device": wire,
        "by_type": analysis.collective_by_type(),
        "counts": analysis.collective_counts(),
    }
    terms = roofline_terms(flops, hbm_bytes, analysis.collectives)
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(cfg, shape_name, plan.size, batch=b, seq=s)
    result["roofline"] = {
        **terms,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_flops_ratio": (mf / flops) if flops else 0.0,
    }
    if save_trace:
        with open(save_trace, "w") as f:
            json.dump({k: dataclasses.asdict(v) for k, v in analysis.by_op.items()}, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--layout", default="2d", choices=list(LAYOUTS))
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-trace", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (e.g. attn_chunk=512)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(specs_lib.INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.layout != "2d":
                    tag += f"_{args.layout}"
                if overrides:
                    tag += "_" + "_".join(f"{k}-{v}" for k, v in overrides.items())
                try:
                    res = dryrun_one(
                        arch, shape, multi_pod=mp, overrides=overrides or None,
                        fsdp=not args.no_fsdp, layout=args.layout,
                        save_trace=args.save_trace,
                    )
                except Exception as e:  # noqa: BLE001 — record & continue sweep
                    res = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": f"FAIL: {type(e).__name__}: {e}",
                        "traceback": traceback.format_exc(),
                    }
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=2, default=str)
                r = res.get("roofline", {})
                mem = res.get("memory", {})
                # "<=" marks an upper bound (a tensor-parallel plan).
                le = "<=" if res.get("cost", {}).get("upper_bounds") else "="
                print(
                    f"{tag}: {res['status']}"
                    + (
                        f" compute{le}{r['compute_s']:.3e}s memory{le}{r['memory_s']:.3e}s"
                        f" coll={r['collective_s']:.3e}s dom={r['dominant']}"
                        f" useful={r['useful_flops_ratio']:.2f}"
                        f" peak{le}{mem['peak_bytes_per_device'] / 1e9:.2f}GB"
                        f" trace={res['lower_compile_s']}s"
                        if r
                        else ""
                    ),
                    flush=True,
                )
    if failures:
        raise SystemExit(f"{failures} dry-run combination(s) failed")
    return 0


if __name__ == "__main__":
    main()
