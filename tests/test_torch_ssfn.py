"""repro_torch.core.ssfn and repro_torch.convert against repro.core.ssfn.

The same numpy parameters and inputs go through both packages.  The
assembled weights agree bit for bit (V_Q O_l is an exact signed copy in
both).  Forward passes agree to rtol/atol 1e-5: both sum in f32 but
through different BLAS kernels (XLA's and PyTorch's CPU GEMMs), so the
sums round in a different order, an error of a few f32 ulps per layer at
these sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ssfn as jssfn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ssfn as tssfn

TOL = dict(rtol=1e-5, atol=1e-5)


def _stack(p, q, n, layers, seed=0):
    rng = np.random.default_rng(seed)

    def draw(rows, fan_in):
        return (rng.standard_normal((rows, fan_in)) / np.sqrt(fan_in)).astype(np.float32)

    o = [draw(q, p)] + [draw(q, n) for _ in range(layers)]
    r = [draw(n - 2 * q, p if l == 0 else n) for l in range(layers)]
    return o, r


def _both(o, r):
    jp = jssfn.SSFNParams(o=tuple(map(jnp.asarray, o)), r=tuple(map(jnp.asarray, r)))
    return jp, params_from_numpy(o, r, device="cpu")


# (P, Q, n, L): the reference's serve-test geometry, and a 128-aligned one.
GEOMETRIES = [(8, 3, 20, 2), (128, 4, 256, 2)]


def test_config_mirrors_reference():
    t = tssfn.SSFNConfig(input_dim=784, num_classes=10)
    j = jssfn.SSFNConfig(input_dim=784, num_classes=10)
    assert t.n == j.n == 1020
    assert t.num_layers == j.num_layers == 20
    assert t.eps_radius == j.eps_radius
    assert t.dtype == torch.float32
    with pytest.raises(ValueError, match="exceed 2Q"):
        tssfn.SSFNConfig(input_dim=8, num_classes=3, hidden=6)


def test_v_q_matches_reference():
    assert np.array_equal(tssfn.v_q(4).numpy(), np.asarray(jssfn.v_q(4)))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_assembled_weights_bit_exact(geom):
    o, r = _stack(*geom)
    jp, tp = _both(o, r)
    q = geom[1]
    jw = jssfn.assemble_weights(jp, q)
    tw = tssfn.assemble_weights(tp, q)
    assert len(jw) == len(tw) == geom[3]
    for a, b in zip(jw, tw):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_build_weight_rejects_wrong_readout_rows():
    o, r = _stack(8, 3, 20, 1)
    with pytest.raises(ValueError, match="Q=4"):
        tssfn.build_weight(torch.from_numpy(o[0]), torch.from_numpy(r[0]), 4)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_forward_predict_classify_match_reference(geom):
    p, q, _, layers = geom
    o, r = _stack(*geom, seed=1)
    jp, tp = _both(o, r)
    x = np.random.default_rng(2).standard_normal((p, 16)).astype(np.float32)
    jw = jssfn.assemble_weights(jp, q)
    tw = tssfn.assemble_weights(tp, q)
    for upto in (1, None):
        np.testing.assert_allclose(
            tssfn.forward_features(tw, torch.from_numpy(x), upto=upto).numpy(),
            np.asarray(jssfn.forward_features(jw, jnp.asarray(x), upto=upto)),
            **TOL,
        )
    want = np.asarray(jssfn.predict(jp, jnp.asarray(x), q))
    got = tssfn.predict(tp, torch.from_numpy(x), q).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # Labels agree wherever the reference's top two logits are separated
    # by more than the tolerance.
    top2 = np.sort(want, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-4
    assert np.array_equal(
        tssfn.classify(tp, torch.from_numpy(x), q).numpy()[clear],
        np.asarray(jssfn.classify(jp, jnp.asarray(x), q))[clear],
    )


def test_layer_cost_matches_reference():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((3, 20)).astype(np.float32)
    y = rng.standard_normal((20, 9)).astype(np.float32)
    t = rng.standard_normal((3, 9)).astype(np.float32)
    want = float(jssfn.layer_cost(jnp.asarray(o), jnp.asarray(y), jnp.asarray(t)))
    got = float(tssfn.layer_cost(*(torch.from_numpy(a) for a in (o, y, t))))
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


def test_params_round_trip_bit_exact():
    o, r = _stack(8, 3, 20, 2)
    tp = params_from_numpy(o, r, device="cpu")
    assert isinstance(tp, tssfn.SSFNParams)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in tp.o + tp.r)
    o2, r2 = params_to_numpy(tp)
    for a, b in zip(o + r, o2 + r2):
        assert b.dtype == np.float32 and np.array_equal(a, b)


def test_params_bf16_round_trip_is_bf16_rounding():
    o, r = _stack(8, 3, 20, 1)
    tp = params_from_numpy(o, r, device="cpu", dtype=torch.bfloat16)
    assert tp.o[0].dtype == torch.bfloat16
    o2, _ = params_to_numpy(tp)
    want = torch.from_numpy(o[0]).to(torch.bfloat16).float().numpy()
    assert np.array_equal(o2[0], want)


def test_params_from_numpy_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o, r = _stack(8, 3, 20, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(o, r)
