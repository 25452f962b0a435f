"""The port's spmdlint on the card: needs an NVIDIA GPU and skips without one.

Like ``tests/test_torch_cuda.py`` this file imports neither JAX nor
``repro``:

    python -m pytest -q --noconftest tests/test_torch_analysis_cuda.py

The numerics and serve checks run through the real kernels, whose
wrappers report each launch to the recording: a layer step's record
holds one ``gram`` (layer 0) or ``propagate_gram`` (later layers) launch
accumulating in f32 and every factorization under ``guarded_cholesky``;
a bucket program's holds one ``matmul_relu`` launch a layer.  A bf16
engine still reports ``numerics-accum`` (its readout), and the probes
leave the engine's ``cache_info()`` as it was.
"""
import pytest
import torch

from repro_torch import analysis, dssfn
from repro_torch.core import engine as engine_lib
from repro_torch.core.backend import SimulatedBackend

M, N_PREV, N, Q, J = 4, 12, 24, 3, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _checks(findings):
    return sorted({f.check for f in findings})


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["exact", "gossip:3:wire=bf16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_layer_step_record_holds_the_gram_kernel(cuda, spec, layer):
    g = torch.Generator(device=cuda).manual_seed(0)
    y = torch.randn((M, N_PREV, J), device=cuda, generator=g)
    t = torch.randn((M, Q, J), device=cuda, generator=g)
    w = torch.randn((N, N_PREV), device=cuda, generator=g) if layer else None
    policy = dssfn.parse_spec(spec)
    with analysis.recording() as record:
        step = engine_lib.fused_layer_step(
            SimulatedBackend(M, policy=policy), y, t, w, mu=1e-2, eps_radius=6.0,
            num_iters=8, trace_every=0)
    assert torch.isfinite(step.o_star).all()
    assert analysis.lint_record(record, subject=spec) == []
    (kernel,) = record.kernels()
    assert kernel.name == ("kernel:propagate_gram" if layer else "kernel:gram")
    assert kernel.accum_dtype == "f32"
    factorizations = [c for c in record.calls if c.name in analysis.numerics.FACTORIZATIONS]
    assert factorizations and all(c.guarded for c in factorizations)


@pytest.mark.cuda
def test_serve_contract_on_the_card(cuda):
    engine = analysis.synthetic_serve_engine(buckets=(1, 4), device=cuda)
    engine.forward(torch.zeros((engine.request_dim, 2)))
    before = engine.cache_info()
    assert analysis.check_serve_contract(engine, subject="serve:card") == []
    assert engine.cache_info() == before
    texts = engine.lowering_texts(bucket=4)
    kernels = texts["program"].kernels()
    assert [k.name for k in kernels] == ["kernel:matmul_relu"] * 2
    assert {k.accum_dtype for k in kernels} == {"f32"}
    assert analysis.check_serve_surface(device=cuda) == []

    bf16 = analysis.synthetic_serve_engine(dtype=torch.bfloat16, buckets=(1,), device=cuda)
    found = analysis.check_serve_contract(bf16, subject="serve:bf16")
    assert _checks(found) == ["numerics-accum"]
    assert {f.details["op"] for f in found} == {"matmul"}  # the readout, not the kernel


@pytest.mark.cuda
def test_cli_numerics_and_serve_on_the_card(cuda):
    from repro_torch.launch import lint_dssfn

    assert lint_dssfn.main(["--all-grammar", "--checks", "numerics,serve",
                            "--format", "json"]) == 0
