"""The serving runtime on the card: needs an NVIDIA GPU and skips
without one.

Like ``tests/test_torch_cuda.py`` this file imports neither JAX nor
``repro``, so it runs on a host that has only the port's dependencies:

    python -m pytest -q --noconftest tests/test_torch_runtime_cuda.py

Every propagation launches ``matmul_relu``, before and after the circuit
breaker opens.  The plain version it is held against (``matmul_relu_ref``
at every layer, cuBLAS and relu) sums in f32 in another order: rtol/atol
1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn
from repro_torch.kernels.matmul_relu import launch_count, matmul_relu_ref
from repro_torch.serve import (
    ManualClock,
    ServeEngine,
    ServeRuntime,
    TransientEngineError,
    export_artifact,
    load_artifact,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _small_stack_path(tmp_path, p=64, q=4, n=40, layers=3, seed=2):
    rng = np.random.default_rng(seed)
    o = [(rng.standard_normal((q, p)) / 8).astype(np.float32)]
    o += [(rng.standard_normal((q, n)) / 8).astype(np.float32) for _ in range(layers)]
    r = [(rng.standard_normal((n - 2 * q, p if l == 0 else n)) / 8).astype(np.float32)
         for l in range(layers)]
    path = str(tmp_path / "stack")
    export_artifact(path, params_from_numpy(o, r, device="cpu"))
    return path, p, layers


def _plain_forward(path, x):
    """The stack through ``matmul_relu_ref`` at every layer, on the card."""
    art = load_artifact(path)
    y = x.cuda()
    for w in ssfn.assemble_weights(art.params, art.num_classes):
        y = matmul_relu_ref(w.cuda(), y)
    return art.params.o[-1].cuda() @ y


@pytest.mark.cuda
def test_engine_launches_kernel_on_card(cuda, tmp_path):
    """Every forward launches the kernel once a layer and agrees with the
    plain version."""
    path, p, layers = _small_stack_path(tmp_path)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((p, 8)).astype(np.float32))
    engine = ServeEngine(path, buckets=(8,))
    before = launch_count()
    y = engine.forward(x)
    torch.cuda.synchronize()
    assert launch_count() == before + layers
    np.testing.assert_allclose(y.cpu().numpy(), _plain_forward(path, x).cpu().numpy(), **TOL)


class _Failing:
    def on_engine_call(self, clock):
        raise TransientEngineError("injected")


@pytest.mark.cuda
def test_runtime_breaker_keeps_card_route(cuda, tmp_path):
    """An open breaker holds the engine off for its cooldown and changes
    nothing else: no kernels-disabled, and the probe after it launches
    the kernel at every layer, bit-equal to a direct forward."""
    path, p, layers = _small_stack_path(tmp_path)
    engine = ServeEngine(path, buckets=(8,))
    rt = ServeRuntime(engine, clock=ManualClock(), max_batch=8, max_retries=0,
                      breaker_threshold=1, breaker_cooldown_s=0.01).start()
    x = np.random.default_rng(4).standard_normal((p, 8)).astype(np.float32)
    before = launch_count()
    h = rt.submit(x)
    assert h.ok() and launch_count() == before + layers
    rt.chaos = _Failing()
    assert rt.submit(x).status == "failed"
    assert rt.breaker == "open" and rt.degraded_reasons == ()
    rt.chaos = None
    rt.clock.advance(0.02)
    before = launch_count()
    h2 = rt.submit(x)
    assert h2.ok() and launch_count() == before + layers
    assert torch.equal(h2.result(), h.result())
    assert rt.breaker == "closed" and rt.state == "READY"
    assert "degrade" not in [e["kind"] for e in rt.events]


@pytest.mark.cuda
def test_runtime_admits_card_tensor(cuda, tmp_path):
    """A request that arrives on the card is copied to the host once and
    served like a host array, not counted as poison."""
    path, p, _ = _small_stack_path(tmp_path)
    rt = ServeRuntime(ServeEngine(path, buckets=(8,)), clock=ManualClock(),
                      max_batch=8).start()
    x = np.random.default_rng(5).standard_normal((p, 4)).astype(np.float32)
    h_host, h_card = rt.submit(x), rt.submit(torch.from_numpy(x).cuda())
    rt.flush()
    assert h_host.ok() and h_card.ok()
    assert torch.equal(h_host.result(), h_card.result())
    assert rt.stats["rejected_poison"] == 0
