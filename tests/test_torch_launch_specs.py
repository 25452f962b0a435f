"""The port's input specs and sharding spec trees (``launch/specs.py``)
against ``repro``'s on the CPU: a port of ``tests/test_launch_specs.py``
and ``tests/test_infra.py::test_param_specs_drop_nondivisible``, then,
for all ten full configs on both production plans and all three layouts,
every param, optimizer-state, cache and batch leaf against ``repro``'s
``jax.eval_shape`` tree and spec trees, leaf by leaf (``repro`` gets a
stand-in mesh: no device is made, nothing lowers).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_sharding_rules import reference_rules, standin

from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.dryrun import LAYOUTS, _init_params, layout_rules
from repro_torch.launch.mesh import MeshPlan, make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.sharding.rules import AxisRules

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}
PLANS = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", list(specs_lib.INPUT_SHAPES))
def test_input_specs_consistent(arch, shape_name):
    cfg = get_config(arch)
    info = specs_lib.INPUT_SHAPES[shape_name]
    batch = specs_lib.batch_specs(cfg, shape_name)
    b = info["batch"]
    assert all(v.device.type == "meta" for v in batch.values())
    assert batch["tokens"].shape[0] == b
    assert batch["tokens"].dtype == torch.int32
    if info["kind"] == "decode":
        assert batch["tokens"].shape[1] == 1
    else:
        seq_dims = batch["tokens"].shape[1]
        if cfg.family == "vlm":
            assert seq_dims + cfg.num_patches == info["seq"]
            assert batch["patch_embeds"].shape == (b, cfg.num_patches, cfg.patch_dim)
            assert batch["patch_embeds"].dtype == torch.bfloat16
        else:
            assert seq_dims == info["seq"]
    if cfg.family == "audio":
        assert batch["tokens"].shape[-1] == cfg.num_codebooks
    if info["kind"] == "train":
        assert "labels" in batch
    # ... and repro's, key for key.
    ref = j_specs.batch_specs(j_get_config(arch), shape_name)
    assert list(batch) == list(ref)
    for k, v in ref.items():
        assert tuple(batch[k].shape) == v.shape and batch[k].dtype == DTYPES[v.dtype], k


def test_batch_specs_take_a_device_share():
    cfg = get_config("internvl2_1b")
    batch = specs_lib.batch_specs(cfg, "train_4k", batch=16, seq=1024)
    assert batch["tokens"].shape == (16, 1024 - cfg.num_patches)
    assert batch["patch_embeds"].shape == (16, cfg.num_patches, cfg.patch_dim)


@functools.cache
def port_params(arch):
    return _init_params(get_config(arch))


@functools.cache
def reference_params(arch):
    return jax.eval_shape(j_build_model(j_get_config(arch)).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_shapes(arch):
    """The FULL production config's params (meta tensors, no allocation):
    the analytic count's order, and ``repro``'s count exactly."""
    cfg = get_config(arch)
    total = sum(leaf.numel() for _, leaf in specs_lib.leaves_with_path(port_params(arch)))
    analytic = cfg.param_count()
    assert 0.5 * analytic < total < 2.0 * analytic, (arch, total, analytic)
    assert total == sum(math.prod(x.shape) for x in jax.tree.leaves(reference_params(arch)))


@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2_7b", "xlstm_350m",
                                  "mixtral_8x22b", "h2o_danube3_4b"])
def test_full_config_cache_shapes(arch):
    """Decode caches for the full configs stay bounded for SWA/SSM archs."""
    cfg = get_config(arch)
    model = build_model(cfg)
    for shape_name in ("decode_32k", "long_500k"):
        if shape_name == "long_500k" and not cfg.sub_quadratic:
            continue
        info = specs_lib.INPUT_SHAPES[shape_name]
        cache = model.init_cache(info["batch"], info["seq"], device="meta")
        leaves = [leaf for _, leaf in specs_lib.leaves_with_path(cache)]
        total_bytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
        # Global cache must fit the pod (256 x 80 GB), with margin.
        assert total_bytes < 2e12, (arch, shape_name, total_bytes)
        if cfg.attention == "swa" and cfg.family == "dense":
            # ring buffer: slots bounded by the window regardless of seq
            k = leaves[0]
            assert cfg.window in k.shape or k.shape[2] <= cfg.window


def test_long500k_run_skip_partition():
    runs = {a for a in ARCHS if get_config(a).sub_quadratic}
    assert runs == {
        "xlstm_350m", "zamba2_2_7b", "h2o_danube3_4b", "h2o_danube_1_8b",
        "mixtral_8x22b",
    }


def test_param_specs_drop_nondivisible():
    plan = MeshPlan(("data", "model"), (1, 1))
    rules = AxisRules(mesh=plan, data_axes=("data",), model_axis="model")
    shapes = {"layers": {"attn": {"wq": torch.empty((3, 5), device="meta")}}}
    specs = specs_lib.param_spec_tree(shapes, rules, plan)
    # (1,1) plan: everything divides; spec carries the logical axes
    assert specs["layers"]["attn"]["wq"] == ("data", "model")
    plan = MeshPlan(("data", "model"), (2, 4))
    specs = specs_lib.param_spec_tree(shapes, AxisRules(mesh=plan), plan)
    assert specs["layers"]["attn"]["wq"] == (None, None)
    shapes["layers"]["attn"]["wq"] = torch.empty((7, 4, 12), device="meta")
    specs = specs_lib.param_spec_tree(shapes, AxisRules(mesh=plan), plan)
    assert specs["layers"]["attn"]["wq"] == (None, "data", "model")


def _leaves(tree):
    return [leaf for _, leaf in specs_lib.leaves_with_path(tree)]


def _specs(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _same_leaves(mine, ref, what):
    """Same leaves, in ``jax.tree.leaves`` order, shape and dtype."""
    mine_l = specs_lib.leaves_with_path(mine)
    ref_l = jax.tree_util.tree_leaves_with_path(ref)
    assert len(mine_l) == len(ref_l), what
    for (path, leaf), (jpath, jleaf) in zip(mine_l, ref_l):
        keys = [getattr(k, "key", None) for k in jpath]
        assert [k for k in path if isinstance(k, str)] == [k for k in keys if k], (what, path)
        assert tuple(leaf.shape) == jleaf.shape, (what, path)
        assert leaf.dtype == DTYPES[jleaf.dtype], (what, path)


def _same_specs(mine, ref_tree, like, what):
    got = [specs_lib.lookup(mine, p) for p, _ in specs_lib.leaves_with_path(like)]
    want = [tuple(s) for s in _specs(ref_tree)]
    assert got == want, what


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_are_the_references_leaf_by_leaf(arch):
    """Params, AdamW state, decode caches and batches of the full config,
    on both production plans and in all three layouts (and the 2d layout
    without FSDP): shapes, dtypes and specs as ``repro``'s."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    params, jparams = port_params(arch), reference_params(arch)
    _same_leaves(params, jparams, "params")
    state = AdamW().init(params)
    jstate = jax.eval_shape(JAdamW(lr=1e-4).init, jparams)
    _same_leaves(state, jstate, "opt")
    caches = {}
    for shape_name in ("decode_32k", "long_500k"):
        info = specs_lib.INPUT_SHAPES[shape_name]
        b, s = info["batch"], info["seq"]
        caches[shape_name] = (model.init_cache(b, s, device="meta"),
                              jax.eval_shape(lambda: jmodel.init_cache(b, s)), b)
        _same_leaves(*caches[shape_name][:2], shape_name)
    for plan_name, plan in PLANS.items():
        mesh = standin(plan)
        for layout, fsdp in [(x, True) for x in LAYOUTS] + [("2d", False)]:
            what = (plan_name, layout, fsdp)
            rules, jrules = layout_rules(layout, plan, fsdp), reference_rules(layout, plan, fsdp)
            pspec = specs_lib.param_spec_tree(params, rules, plan)
            jpspec = j_specs.param_spec_tree(jparams, jrules, mesh)
            _same_specs(pspec, jpspec, params, what + ("params",))
            ospec = specs_lib.opt_state_spec_tree(state, pspec)
            _same_specs(ospec, j_specs.opt_state_spec_tree(jstate, jpspec), state,
                        what + ("opt",))
            for shape_name, (cache, jcache, b) in caches.items():
                cspec = specs_lib.cache_spec_tree(cache, cfg, b, rules, plan)
                jcspec = j_specs.cache_spec_tree(jcache, jcfg, b, jrules, mesh)
                _same_specs(cspec, jcspec, cache, what + (shape_name,))
            for shape_name, info in specs_lib.INPUT_SHAPES.items():
                batch = specs_lib.batch_specs(cfg, shape_name)
                got = specs_lib.batch_spec_tree(batch, rules, plan, info["batch"])
                want = j_specs.batch_spec_tree(j_specs.batch_specs(jcfg, shape_name), jrules,
                                               mesh, info["batch"])
                assert got == {k: tuple(v) for k, v in want.items()}, what + (shape_name,)


def _independent_bytes(tree, spec_leaves, sizes):
    """Each leaf's bytes over the product of its spec's axis sizes."""
    total = 0
    for leaf, spec in zip(_leaves(tree), spec_leaves):
        split = 1
        for names in spec:
            for n in (names if isinstance(names, tuple) else (names,) if names else ()):
                split *= sizes[n]
        total += leaf.numel() * leaf.element_size() / split
    return total


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "phi35_moe_42b", "zamba2_2_7b",
                                  "xlstm_350m", "musicgen_medium"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_per_device_bytes_against_an_independent_sum(arch, layout):
    plan = make_production_mesh(multi_pod=True)
    params = port_params(arch)
    jrules = reference_rules(layout, plan)
    jpspec = _specs(j_specs.param_spec_tree(reference_params(arch), jrules, standin(plan)))
    pspec = specs_lib.param_spec_tree(params, layout_rules(layout, plan), plan)
    got = specs_lib.per_device_bytes(params, pspec, plan)
    assert got == _independent_bytes(params, [tuple(s) for s in jpspec], plan.axis_sizes)
    whole = sum(x.numel() * x.element_size() for x in _leaves(params))
    assert whole / plan.size <= got <= whole
    # A replicated tree is whole on every device.
    assert specs_lib.per_device_bytes(params, specs_lib.tree_map_with_path(
        lambda _, x: (), params), plan) == whole


def test_tree_helpers_keep_named_tuples():
    cfg = get_config("zamba2_2_7b").reduced()
    cache = build_model(cfg).init_cache(2, 64, device="meta")
    mapped = specs_lib.tree_map_with_path(lambda p, x: p, cache)
    assert type(mapped) is type(cache) and type(mapped.attn) is type(cache.attn)
    assert mapped.attn.index == (1, 2)
    assert [p for p, _ in specs_lib.leaves_with_path(cache)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
    assert np.array_equal(specs_lib.lookup(cache, (1, 2)).shape, cache.attn.index.shape)
