"""The port's mesh plans and sharding rules (``launch/mesh.py``'s plan half,
``sharding/rules.py``) against ``repro``'s on the CPU.

``repro``'s rules take a ``Mesh``; a stand-in with its ``axis_names`` and
``devices.shape`` (no device is made) holds the place of the production
mesh.  Its dry-run modules are never imported here: they set XLA_FLAGS
for 512 host devices when imported.
"""
import math
import types

import numpy as np
import pytest

from repro.launch import mesh as j_mesh
from repro.sharding import rules as j_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import LAYOUTS, layout_rules
from repro_torch.sharding import rules

LOGICAL = (None, "batch", "fsdp", "tensor", "workers")


def standin(plan):
    """A ``repro`` mesh stand-in for ``plan``: axis names and a device
    array of the plan's shape."""
    return types.SimpleNamespace(axis_names=plan.axis_names,
                                 devices=np.empty(plan.shape, object))


def reference_rules(layout, plan, fsdp=True, worker_axis=None):
    """``repro/launch/dryrun.py``'s rules for ``layout`` (its :80-112)."""
    mesh = standin(plan)
    data = tuple(a for a in plan.axis_names if a in ("pod", "data"))
    if layout == "2d":
        return j_rules.AxisRules(mesh=mesh, data_axes=data, model_axis="model", fsdp=fsdp,
                                 worker_axis=worker_axis)
    if layout == "fsdp":
        return j_rules.AxisRules(mesh=mesh, data_axes=data + ("model",), model_axis=None,
                                 fsdp=fsdp, worker_axis=worker_axis)
    return j_rules.AxisRules(mesh=mesh, data_axes=(), fsdp_axes=data, model_axis="model",
                             fsdp=True, worker_axis=worker_axis)


def test_param_rules_are_the_references():
    assert rules.PARAM_RULES == j_rules.PARAM_RULES
    assert list(rules.PARAM_RULES) == list(j_rules.PARAM_RULES)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_plans_are_the_references_meshes(multi_pod):
    plan = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert plan.shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert plan.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert plan.size == math.prod(plan.shape) == (512 if multi_pod else 256)
    assert plan.axis_sizes == dict(zip(plan.axis_names, plan.shape))
    assert mesh_lib.data_axes_for(plan) == j_mesh.data_axes_for(standin(plan))


def test_plan_refuses_a_malformed_shape():
    with pytest.raises(ValueError):
        mesh_lib.MeshPlan(("data", "model"), (16,))
    with pytest.raises(ValueError):
        mesh_lib.MeshPlan(("data",), (0,))


def test_hardware_is_the_h100s():
    hw = mesh_lib.HARDWARE
    assert hw["peak_flops_bf16"] == 989e12 and hw["hbm_bandwidth"] == 3.35e12
    assert hw["nvlink_bandwidth"] == 450e9 and hw["internode_bandwidth"] == 50e9
    # No figure of the reference's TPU v5e chip (its 50e9 B/s ICI link
    # equals NDR InfiniBand's 400 Gb/s by coincidence, under another name).
    v5e = {k: v for k, v in j_mesh.HARDWARE.items() if k != "ici_link_bandwidth"}
    assert not set(hw.values()) & set(v5e.values())
    assert mesh_lib.link_bandwidth(8) == 450e9
    assert mesh_lib.link_bandwidth(16) == mesh_lib.link_bandwidth(256) == 50e9


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("worker_axis", [None, "model"])
def test_spec_resolves_every_logical_axis_as_repro(layout, multi_pod, fsdp, worker_axis):
    plan = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mine = layout_rules(layout, plan, fsdp)
    if worker_axis:
        mine = rules.AxisRules(**{**mine.__dict__, "worker_axis": worker_axis})
    ref = reference_rules(layout, plan, fsdp, worker_axis)
    assert mine.weight_axes == ref.weight_axes
    combos = [(a,) for a in LOGICAL] + [(a, b) for a in LOGICAL for b in LOGICAL] + [()]
    with rules.use_rules(mine), j_rules.use_rules(ref):
        for axes in combos:
            assert rules.spec(*axes) == tuple(j_rules.spec(*axes)), axes


def test_spec_without_rules_and_unknown_axes():
    assert rules.current_rules() == rules.AxisRules()
    combos = [(a, b) for a in LOGICAL for b in LOGICAL]
    for axes in combos:
        assert rules.spec(*axes) == tuple(j_rules.spec(*axes)), axes
    with pytest.raises(ValueError):
        rules.spec("sequence")
    with pytest.raises(ValueError):
        j_rules.spec("sequence")


def test_use_rules_nests_and_restores():
    plan = mesh_lib.make_production_mesh()
    outer, inner = layout_rules("2d", plan), layout_rules("tp2d", plan)
    with rules.use_rules(outer):
        with pytest.raises(RuntimeError):
            with rules.use_rules(inner):
                assert rules.current_rules() is inner
                raise RuntimeError("inside")
        assert rules.current_rules() is outer
    assert rules.current_rules() == rules.AxisRules()
