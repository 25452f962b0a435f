"""The port's dry run of the model zoo (``launch/dryrun.py``) on the CPU:
``repro``'s result keys for every kind and layout, the argument bytes
against an independent per-leaf sum over ``repro``'s spec trees, the
modelled collectives on a (2, 2) plan against a count made here from the
leaf list, one device's share of the tensor-parallel products,
``repro``'s ``model_flops_per_device`` for every arch and shape on both
meshes, the full-attention skip and the CLI.

``repro.launch.dryrun`` is never imported here: it sets XLA_FLAGS for 512
host devices when imported.  Its keys and its formula are read from its
source instead.
"""
import ast
import dataclasses
import json
import os

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_sharding_rules import reference_rules, standin

from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import MeshPlan
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.sharding.rules import PARAM_RULES

REFERENCE = os.path.join(os.path.dirname(j_specs.__file__), "dryrun.py")
PLAN22 = MeshPlan(("data", "model"), (2, 2))
BATCH, SEQ = 32, 64


def _reference_source():
    with open(REFERENCE) as f:
        text = f.read()
    return text, ast.parse(text)


def _reference_keys():
    """``repro``'s result keys: the top level, and each nested dict's."""
    _, tree = _reference_source()
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    terms = {k.value for n in ast.walk(fns["roofline_terms"]) if isinstance(n, ast.Dict)
             for k in n.keys if isinstance(k, ast.Constant)}
    top, nested = set(), {}
    for node in ast.walk(fns["dryrun_one"]):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "result" and isinstance(node.value, ast.Dict):
            top |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "result":
            key = node.targets[0].slice.value
            top.add(key)
            if isinstance(node.value, ast.Dict):
                keys = {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
                if any(k is None for k in node.value.keys):
                    keys |= terms
                nested[key] = keys
    return top, nested


def _reduced(arch):
    cfg, small = get_config(arch), get_config(arch).reduced()
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(cfg)
            if getattr(small, f.name) != getattr(cfg, f.name)}


@pytest.mark.parametrize("arch,shape_name,layout", [
    (a, s, "2d") for a in ("h2o_danube3_4b", "phi35_moe_42b", "internvl2_1b",
                           "musicgen_medium", "zamba2_2_7b")
    for s in ("train_4k", "prefill_32k", "decode_32k")
] + [("xlstm_350m", "decode_32k", "2d"), ("xlstm_350m", "long_500k", "2d")] + [
    ("h2o_danube3_4b", s, lay) for s in ("train_4k", "prefill_32k", "decode_32k")
    for lay in ("fsdp", "tp2d")])
def test_result_has_the_references_keys(arch, shape_name, layout):
    res = dryrun.dryrun_one(arch, shape_name, overrides=_reduced(arch), layout=layout,
                            batch=BATCH, seq=SEQ)
    top, nested = _reference_keys()
    assert res["status"] == "OK"
    assert set(res) == top
    for key, keys in nested.items():
        if key == "cost":   # no xla_cost_analysis_* counterpart
            keys = {k for k in keys if not k.startswith("xla_cost_analysis")}
        assert keys <= set(res[key]), key
    mem = res["memory"]
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + mem["temp_bytes"] > 0
    assert res["cost"]["flops_per_device"] > 0 and res["cost"]["hbm_bytes_per_device"] > 0
    r = res["roofline"]
    assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"), key=r.get)
    assert r["useful_flops_ratio"] == r["model_flops_per_device"] / res["cost"]["flops_per_device"]


def _specs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def _reference_trees(arch, plan, kind):
    """``repro``'s spec lists for the reduced config on ``plan``: params,
    opt state, batch, caches (as applicable)."""
    cfg = dataclasses.replace(j_get_config(arch), **_reduced(arch))
    model = j_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rules, mesh = reference_rules("2d", plan), standin(plan)
    pspec = j_specs.param_spec_tree(params, rules, mesh)
    out = {"params": _specs(pspec)}
    if kind == "train":
        opt = jax.eval_shape(JAdamW(lr=1e-4).init, params)
        out["opt"] = _specs(j_specs.opt_state_spec_tree(opt, pspec))
    if kind == "decode":
        cache = jax.eval_shape(lambda: model.init_cache(BATCH, SEQ))
        out["cache"] = _specs(j_specs.cache_spec_tree(cache, cfg, BATCH, rules, mesh))
    return out


def _bytes(tensors, spec_list, plan):
    total = 0
    for leaf, spec in zip(tensors, spec_list):
        split = 1
        for names in spec:
            for n in (names if isinstance(names, tuple) else (names,) if names else ()):
                split *= plan.axis_sizes[n]
        total += leaf.numel() * leaf.element_size() / split
    return total


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "zamba2_2_7b", "phi35_moe_42b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_argument_bytes_against_an_independent_sum(arch, shape_name):
    kind = specs_lib.INPUT_SHAPES[shape_name]["kind"]
    res = dryrun.dryrun_one(arch, shape_name, overrides=_reduced(arch), plan=PLAN22,
                            batch=BATCH, seq=SEQ)
    cfg = dataclasses.replace(get_config(arch), **_reduced(arch))
    ref = _reference_trees(arch, PLAN22, kind)
    params = [x for _, x in specs_lib.leaves_with_path(dryrun._init_params(cfg))]
    want = _bytes(params, ref["params"], PLAN22)
    if kind == "train":
        state = AdamW(lr=1e-4).init(dryrun._init_params(cfg))
        want += _bytes([x for _, x in specs_lib.leaves_with_path(state)], ref["opt"], PLAN22)
    else:
        cache = build_model(cfg).init_cache(BATCH, SEQ, device="meta")
        want += _bytes([x for _, x in specs_lib.leaves_with_path(cache)], ref["cache"], PLAN22)
    batch = specs_lib.batch_specs(cfg, shape_name, batch=BATCH, seq=SEQ)
    want += sum(x.numel() * x.element_size() / 2 for x in batch.values())  # over "data"
    assert res["memory"]["argument_bytes"] == want


#: Leading dims that stack a block's layers: (L,), (periods, per period).
STACK_DIMS = {"layers": 1, "mamba": 2, "mlstm": 2, "slstm": 1}


def _tags(name, ndim, spec):
    rule = PARAM_RULES.get(name)
    if rule is None or not spec:
        return {}
    lead = ndim - len(rule)
    return {t: spec[lead + i] for i, t in enumerate(rule) if t and spec[lead + i]}


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ("h2o_danube3_4b", "zamba2_2_7b", "phi35_moe_42b", "musicgen_medium")
    for s in ("train_4k", "prefill_32k")] + [("xlstm_350m", "decode_32k")])
def test_collective_counts_on_a_2x2_plan(arch, shape_name):
    """The counts derived here from the leaf list: every leaf with an F
    dim all-gathered once a pass (two in training) and its gradient
    reduce-scattered; every other leaf's gradient all-reduced; each block
    with a T-sharded weight all-reduced once a pass per application."""
    kind = specs_lib.INPUT_SHAPES[shape_name]["kind"]
    cfg = dataclasses.replace(get_config(arch), **_reduced(arch))
    seq = 4 * cfg.ssm_chunk if cfg.family == "ssm" else SEQ
    res = dryrun.dryrun_one(arch, shape_name, overrides=_reduced(arch), plan=PLAN22,
                            batch=BATCH, seq=seq)
    params = dryrun._init_params(cfg)
    specs = _reference_trees(arch, PLAN22, kind)["params"]
    passes = 2 if kind == "train" else 1
    want = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    blocks = {}
    for (path, leaf), spec in zip(specs_lib.leaves_with_path(params), specs):
        tags = _tags(path[-1], leaf.ndim, spec)
        if "F" in tags:
            want["all-gather"] += passes
            want["reduce-scatter"] += kind == "train"
        elif kind == "train":
            want["all-reduce"] += 1
        block = path[:2] if path[0] in ("layers", "shared_attn") else path[:1]
        if "T" in tags and len(path) > 1:
            # Applications: the block's stacked layer dims (the shared
            # block: once a Mamba period).
            apps = 1
            for d in leaf.shape[:STACK_DIMS.get(path[0], 0)]:
                apps *= d
            if path[0] == "shared_attn":
                apps = cfg.num_layers // cfg.shared_attn_period
            blocks[block] = apps
    want["all-reduce"] += sum(blocks.values()) * passes
    assert res["collectives"]["counts"] == {k: v for k, v in want.items() if v}


def test_tensor_parallel_products_count_a_devices_share():
    """On a (1, 2) plan each product with a T-sharded weight (here every
    weight product of a dense prefill) counts half its FLOPs: the 1x1
    plan's count less half of those products, summed here from shapes."""
    arch = "h2o_danube3_4b"
    one = dryrun.dryrun_one(arch, "prefill_32k", overrides=_reduced(arch),
                            plan=MeshPlan(("data", "model"), (1, 1)), batch=BATCH, seq=SEQ)
    two = dryrun.dryrun_one(arch, "prefill_32k", overrides=_reduced(arch),
                            plan=MeshPlan(("data", "model"), (1, 2)), batch=BATCH, seq=SEQ)
    cfg = dataclasses.replace(get_config(arch), **_reduced(arch))
    params = dryrun._init_params(cfg)
    tokens = BATCH * SEQ
    products = sum(2 * tokens * leaf.shape[-2] * leaf.shape[-1] * leaf.shape[0]
                   for path, leaf in specs_lib.leaves_with_path(params)
                   if path[-1] in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"))
    # The prefill's logits are the last position's only.
    products += 2 * BATCH * cfg.d_model * cfg.padded_vocab
    assert two["cost"]["flops_per_device"] == one["cost"]["flops_per_device"] - products / 2


def test_tensor_parallel_train_step_counts_a_devices_share():
    """A train step on a (1, 2) plan: the forward, dX and dW products of
    each weight that ``repro``'s spec tree shards over "model" count half,
    everything else whole (attention's own products among them): the 1x1
    plan's count less half of those products, summed here from shapes."""
    arch = "h2o_danube3_4b"
    plans = {k: MeshPlan(("data", "model"), k) for k in ((1, 1), (1, 2))}
    res = {k: dryrun.dryrun_one(arch, "train_4k", overrides=_reduced(arch), plan=p,
                                batch=BATCH, seq=SEQ) for k, p in plans.items()}
    cfg = dataclasses.replace(get_config(arch), **_reduced(arch))
    assert not cfg.remat
    params = dryrun._init_params(cfg)
    specs = _reference_trees(arch, plans[1, 2], "train")["params"]
    tokens = BATCH * SEQ
    products = 0
    for (path, leaf), spec in zip(specs_lib.leaves_with_path(params), specs):
        axes = [a for names in spec for a in (names if isinstance(names, tuple) else (names,))]
        if "model" not in axes or path == ("embed",):   # the embedding is a lookup
            continue
        # Forward, dX and dW: each 2 x tokens x (in x out) for every layer.
        products += 3 * 2 * tokens * leaf.numel()
    assert products > 0
    assert res[1, 2]["cost"]["flops_per_device"] == \
        res[1, 1]["cost"]["flops_per_device"] - products / 2
    assert res[1, 1]["cost"]["upper_bounds"] == []
    assert res[1, 2]["cost"]["upper_bounds"] == list(dryrun.UPPER_BOUNDS)


def _reference_model_flops():
    text, tree = _reference_source()
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "model_flops_per_device")
    namespace = {"specs_lib": j_specs}
    exec(compile(ast.Module([fn], []), REFERENCE, "exec"), namespace)
    return namespace["model_flops_per_device"]


def test_model_flops_per_device_is_the_references():
    ref = _reference_model_flops()
    for arch in ARCHS:
        for shape_name in specs_lib.INPUT_SHAPES:
            for devices in (256, 512):
                assert dryrun.model_flops_per_device(get_config(arch), shape_name, devices) \
                    == ref(j_get_config(arch), shape_name, devices), (arch, shape_name)


@pytest.mark.parametrize("arch", [a for a in ARCHS if not get_config(a).sub_quadratic])
def test_full_attention_skips_long_500k(arch):
    res = dryrun.dryrun_one(arch, "long_500k")
    assert res["status"] == "SKIP(full-attention)"
    assert set(res) == {"arch", "shape", "mesh", "kind", "status"}


def test_cli_exits_zero_and_writes_results(tmp_path, capsys):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--arch", "h2o_danube3_4b", "--shape", "decode_32k", "--both-meshes",
                        "--layout", "tp2d", "--override", "num_layers=6", "--out", out]) == 0
    files = sorted(os.listdir(out))
    assert files == ["h2o_danube3_4b_decode_32k_16x16_tp2d_num_layers-6.json",
                     "h2o_danube3_4b_decode_32k_2x16x16_tp2d_num_layers-6.json"]
    for name in files:
        with open(os.path.join(out, name)) as f:
            assert json.load(f)["status"] == "OK"
    assert capsys.readouterr().out.count(": OK") == 2


def test_cli_records_a_failure_and_exits_nonzero(tmp_path):
    out = str(tmp_path / "dry")
    with pytest.raises(SystemExit, match="1 dry-run combination"):
        dryrun.main(["--arch", "zamba2_2_7b", "--shape", "decode_32k",
                     "--override", "num_layers=5", "--out", out])
    with open(os.path.join(out, "zamba2_2_7b_decode_32k_16x16_num_layers-5.json")) as f:
        res = json.load(f)
    assert res["status"].startswith("FAIL: ValueError") and "traceback" in res


def test_save_trace_writes_the_per_op_breakdown(tmp_path):
    path = str(tmp_path / "ops.json")
    res = dryrun.dryrun_one("h2o_danube3_4b", "decode_32k", overrides={"num_layers": 6},
                            save_trace=path)
    with open(path) as f:
        ops = json.load(f)
    assert sum(v["flops"] for v in ops.values()) == res["cost"]["flops_per_device"]
    assert torch.tensor([v["traffic_bytes"] for v in ops.values()]).sum().item() == \
        pytest.approx(res["cost"]["hbm_bytes_per_device"])
