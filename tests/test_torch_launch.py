"""repro_torch's launchers and the port's hygiene rules.

- ``serve_dssfn`` serves a ``repro``-exported artifact end to end with
  ``--device cpu``, reports ``repro``'s result keys plus ``device`` and
  ``kernel_launches``, and its saved logits equal the engine's.
- ``train_dssfn`` trains with ``--device cpu``, reports ``repro``'s
  result keys plus ``device`` and per-kernel ``kernel_launches``, and its
  ``--export-artifact`` serves through the port's ``serve_dssfn`` and
  loads in ``repro``.
- ``serve`` (the model-zoo launcher) with ``device="cpu"`` and
  ``repro``'s weights gives the greedy tokens of ``repro``'s own prefill
  and decode steps, and for the MoE, VLM and audio models those of
  ``repro``'s own launcher.
- Without ``--device`` every launcher needs CUDA and says how to get the
  CPU.
- No module of the port, nor ``chip_smoke.py``, imports JAX or ``repro``.
- ``chip_smoke.py`` exits non-zero with no result line without CUDA.
"""
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ssfn as jssfn
from repro.serve import export_artifact as j_export
from repro.serve import load_artifact as j_load
from repro_torch.launch import serve, serve_dssfn, train_dssfn
from repro_torch.serve import ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.default_rng(0)
    p, q, n, layers = 8, 3, 20, 2
    o = [rng.standard_normal((q, p)).astype(np.float32)]
    o += [rng.standard_normal((q, n)).astype(np.float32) for _ in range(layers)]
    r = [rng.standard_normal((n - 2 * q, p if l == 0 else n)).astype(np.float32)
         for l in range(layers)]
    path = str(tmp_path_factory.mktemp("tlaunch") / "stack")
    j_export(path, jssfn.SSFNParams(o=tuple(map(jnp.asarray, o)), r=tuple(map(jnp.asarray, r))))
    return path


def test_cli_round_trip_on_cpu(artifact, tmp_path):
    out = str(tmp_path / "res.json")
    logits = str(tmp_path / "logits.npz")
    res = serve_dssfn.main([
        "--artifact", artifact, "--device", "cpu", "--requests", "12",
        "--request-size", "1", "--batch-bucket", "1,4", "--max-wait-us", "0",
        "--out", out, "--save-logits", logits,
    ])
    ref_keys = {"artifact", "buckets", "max_wait_us", "requests", "request_size",
                "wall_time_s", "throughput_samples_per_s", "latency_ms", "batches",
                "mean_batch_size", "compile"}
    assert ref_keys <= set(res)
    assert res["device"] == "cpu" and res["completed"] == 12
    assert res["batches"] == 12 and res["mean_batch_size"] == 1.0
    assert res["kernel_launches"] == 0          # the CPU runs the plain version
    assert res["compile"]["lowerings"] <= 2
    assert res["latency_ms"]["p99"] >= res["latency_ms"]["p50"] >= 0.0
    with open(out) as f:
        assert json.load(f)["requests"] == 12
    with np.load(logits) as z:
        x, got = z["requests"], z["logits"]
    assert x.shape == (8, 12) and got.shape == (3, 12)
    engine = ServeEngine(artifact, buckets=(1, 4), device="cpu")
    want = torch.cat([engine.forward(x[:, i:i + 1]) for i in range(12)], dim=1)
    assert np.array_equal(got, want.numpy())


def test_cli_coalesces_with_max_wait(artifact):
    res = serve_dssfn.main([
        "--artifact", artifact, "--device", "cpu", "--requests", "10",
        "--batch-bucket", "1,4", "--max-wait-us", "1e9",
    ])
    assert res["batches"] == 3 and res["mean_batch_size"] == pytest.approx(10 / 3)


def test_cli_refuses_feature_mismatch(artifact):
    with pytest.raises(SystemExit, match="refusing to serve"):
        serve_dssfn.main(["--artifact", artifact, "--device", "cpu", "--features", "rff:8"])


def test_cli_defaults_to_cuda(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_dssfn.main(["--artifact", artifact, "--requests", "1"])


# ---------------------------------------------------------------------------
# train_dssfn
# ---------------------------------------------------------------------------

# The keys of repro.launch.train_dssfn.train_one's run dict (params aside).
REPRO_RUN_KEYS = {
    "backend", "kind", "policy", "wire_bits", "trace_every", "wall_time_s",
    "test_accuracy", "final_objective", "comm_scalars", "jitter_events",
    "rollbacks", "executable_cache",
}
TRAIN_ARGS = ["--device", "cpu", "--workers", "4", "--layers", "2", "--hidden", "40",
              "--admm-iters", "20", "--train", "480", "--test", "120"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ttrain")
    path, out = str(tmp / "stack"), str(tmp / "res.json")
    res = train_dssfn.main(TRAIN_ARGS + ["--export-artifact", path, "--out", out])
    return res, path, out


def test_train_cli_reports_reference_keys_on_cpu(trained):
    res, path, out = trained
    assert {"config", "runs", "export"} <= set(res) and res["device"] == "cpu"
    (run,) = res["runs"]
    assert REPRO_RUN_KEYS <= set(run)
    assert run["device"] == "cpu"
    assert run["kernel_launches"] == {"gram": 0, "propagate_gram": 0, "matmul_relu": 0}
    assert run["executable_cache"]["lowerings"] == 3      # l=0, l=1, l>=2
    assert run["jitter_events"] == 0 and run["rollbacks"] == 0
    assert run["comm_scalars"] == 6 * (16 + 40 + 40) * 20
    assert 0.0 <= run["test_accuracy"] <= 1.0 and run["final_objective"] > 0
    assert res["export"] == {"path": path, "source_kind": "simulated", "num_layers": 2}
    with open(out) as f:
        assert json.load(f)["runs"][0]["comm_scalars"] == run["comm_scalars"]


def test_trained_artifact_serves_in_the_port_and_loads_in_repro(trained, tmp_path):
    _, path, _ = trained
    logits = str(tmp_path / "logits.npz")
    res = serve_dssfn.main(["--artifact", path, "--device", "cpu", "--requests", "6",
                            "--batch-bucket", "1,4", "--save-logits", logits])
    assert res["completed"] == 6
    art = j_load(path)
    assert art.num_classes == 6 and art.input_dim == 16 and art.num_layers == 2
    assert art.manifest["source"]["trained_by"] == "repro_torch.launch.train_dssfn"
    with np.load(logits) as z:
        want = np.asarray(jssfn.predict(art.params, jnp.asarray(z["requests"]), 6))
        np.testing.assert_allclose(z["logits"], want, rtol=1e-5, atol=1e-5)


def test_train_cli_exports_features_that_serve_like_reference(tmp_path):
    """``--export-features`` records the extractor spec, as repro's
    launcher does; both engines then featurize raw 8-row requests with
    the same seeded weights in front of the trained stack."""
    from repro.serve import ServeEngine as JServeEngine

    path = str(tmp_path / "feat")
    res = train_dssfn.main(TRAIN_ARGS + ["--export-artifact", path,
                                         "--export-features", "relu:16:3"])
    assert res["export"]["path"] == path
    assert j_load(path).features == "relu:16:3"
    x = np.random.default_rng(0).standard_normal((8, 5)).astype(np.float32)
    got = ServeEngine(path, buckets=(8,), device="cpu").forward(x).numpy()
    want = np.asarray(JServeEngine(path, buckets=(8,)).forward(x))
    assert got.shape == (6, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_dssfn.main(["--workers", "2"])


@pytest.mark.parametrize("flag", [["--backend", "mesh"], ["--backend", "both"],
                                  ["--consensus", "quantized:4"]])
def test_train_cli_refuses_unported_modes(flag):
    """The modes the launcher once refused now train on the CPU: the mesh
    backends in two gloo ranks (``--backend both`` beside the simulated
    run, within 1e-4 of it: the ranks sum their workers first, then each
    other's), and the quantized policy with repro's eq.-15 bytes (4 bits
    a scalar)."""
    if flag[0] == "--backend":
        res = train_dssfn.main(TRAIN_ARGS + flag + ["--ranks", "2"])
        run = res["runs"][-1]
        assert run["kind"] == "mesh" and run["ranks"] == 2
        assert run["dist_backend"] == "gloo" and run["device"] == "cpu"
        assert run["comm_scalars"] == 6 * (16 + 40 + 40) * 20
        assert 0.0 <= run["test_accuracy"] <= 1.0
        if flag[1] == "both":
            assert [r["kind"] for r in res["runs"]] == ["simulated", "mesh"]
            assert res["parity"]["max_readout_rel_gap"] < 1e-4
            assert res["parity"]["rel_objective_gap"] < 1e-4
        return
    from repro.launch import train_dssfn as jlaunch

    run = train_dssfn.main(TRAIN_ARGS + flag)["runs"][0]
    jrun = jlaunch.main(TRAIN_ARGS[2:] + flag + ["--backend", "simulated",
                                                 "--no-host-mesh"])["runs"][0]
    assert run["policy"] == jrun["policy"] and run["wire_bits"] == jrun["wire_bits"] == 4
    assert run["comm_scalars"] == jrun["comm_scalars"] == 6 * (16 + 40 + 40) * 20
    assert run["comm_scalars"] * run["wire_bits"] // 8 == \
        jrun["comm_scalars"] * jrun["wire_bits"] // 8
    assert 0.0 <= run["test_accuracy"] <= 1.0


@pytest.mark.parametrize("spec,ratio", [("async:rounds=2:interval=4:drop=0.1:seed=7@ring:1", 2 * 2 / 4),
                                        ("median:rounds=2:byz=1:attack=nanbomb@ring:1", 2 * 2)])
def test_train_cli_trains_async_and_robust_policies(spec, ratio):
    """The fault and robust specs pass through --consensus, as in repro's
    launcher: the same policy and eq.-15 scalars (interval 4 talks on 5
    of the 20 ADMM iterations), finite consensus errors per layer."""
    from repro.launch import train_dssfn as jlaunch

    flag = ["--consensus", spec]
    run = train_dssfn.main(TRAIN_ARGS + flag)["runs"][0]
    jrun = jlaunch.main(TRAIN_ARGS[2:] + flag + ["--backend", "simulated",
                                                 "--no-host-mesh"])["runs"][0]
    assert run["policy"] == jrun["policy"]
    assert run["comm_scalars"] == jrun["comm_scalars"] == ratio * 6 * (16 + 40 + 40) * 20
    assert len(run["consensus_error"]) == 3 and all(np.isfinite(run["consensus_error"]))
    assert run["kernel_launches"] == {"gram": 0, "propagate_gram": 0, "matmul_relu": 0}


# ---------------------------------------------------------------------------
# serve (model zoo)
# ---------------------------------------------------------------------------


def _reference_greedy(arch, batch, prompt_len, gen_len, seed):
    """Greedy tokens from ``repro``'s prefill and decode steps on its
    seeded weights, with the prompt ``repro.launch.serve`` draws."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.models.steps import make_serve_step as j_make_serve_step

    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), jnp.int32)
    logits, cache = model.prefill(params, {"tokens": prompt}, max_len=prompt_len + gen_len)
    step = jax.jit(j_make_serve_step(model))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out = []
    for _ in range(gen_len):
        tok, _, cache = step(params, {"tokens": tok.reshape(batch, 1)}, cache)
        out.append(np.asarray(tok))
    return params, np.stack(out, axis=1)


@pytest.mark.parametrize("arch,prompt_len", [("h2o_danube3_4b", 70), ("stablelm_3b", 20),
                                             ("zamba2_2_7b", 70), ("xlstm_350m", 70)])
def test_serve_gives_the_reference_greedy_tokens(arch, prompt_len):
    """70 prompt tokens past the reduced window of 64: the ring wraps (for
    Zamba2, in its shared attention's KV cache; xLSTM carries only its
    recurrent states, and its 70 tokens pad each mLSTM scan to 80)."""
    import jax

    from repro_torch import convert as conv
    from repro_torch.configs import get_config

    jparams, want = _reference_greedy(arch, 2, prompt_len, 6, seed=3)
    cfg = get_config(arch).reduced()
    convert = {"hybrid": conv.hybrid_params_from_numpy, "ssm": conv.xlstm_params_from_numpy}.get(
        cfg.family, conv.transformer_params_from_numpy)
    params = convert(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    res = serve.serve(arch, batch=2, prompt_len=prompt_len, gen_len=6, seed=3,
                      device="cpu", params=params)
    assert res["device"] == "cpu" and res["tokens"].shape == (2, 6)
    assert np.array_equal(res["tokens"], want)
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "zamba2_2_7b", "xlstm_350m"])
def test_serve_cli_on_cpu(capsys, arch):
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "1",
                      "--prompt-len", "9", "--gen-len", "3", "--seed", "1"])
    assert res["tokens"].shape == (1, 3) and res["tokens"].dtype == np.int64
    out = capsys.readouterr().out
    assert "prefill 9 tok" in out and "tok/s" in out and "sample tokens" in out
    again = serve.serve(arch, batch=1, prompt_len=9, gen_len=3, seed=1, device="cpu")
    assert np.array_equal(again["tokens"], res["tokens"])     # seeded weights and prompt


def test_serve_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "h2o_danube3_4b", "--gen-len", "1"])


@pytest.mark.parametrize("arch,prompt_len", [("mixtral_8x22b", 70), ("internvl2_1b", 20),
                                             ("musicgen_medium", 20)])
def test_serve_gives_the_reference_launchers_greedy_tokens(arch, prompt_len):
    """The MoE, VLM and audio models: the port's launcher with repro's
    weights against repro's own launcher (``repro.launch.serve.serve``:
    its init at PRNGKey(0), its prompt from ``default_rng(seed)``, the
    tokens then a VLM's patches; an audio model's (B, gen, nc) codebook
    tokens).  Mixtral's 70-token prompt wraps its reduced window of 64."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.launch import serve as j_serve
    from repro.models import build_model as j_build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_params_from_numpy

    want = j_serve.serve(arch, batch=2, prompt_len=prompt_len, gen_len=5, seed=3)
    jparams = j_build_model(j_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    params = transformer_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           get_config(arch).reduced(), device="cpu")
    res = serve.serve(arch, batch=2, prompt_len=prompt_len, gen_len=5, seed=3,
                      device="cpu", params=params)
    shape = (2, 5, 4) if arch == "musicgen_medium" else (2, 5)
    assert res["device"] == "cpu" and res["tokens"].shape == shape == want.shape
    assert np.array_equal(res["tokens"], want)


def test_serve_cuts_depth_at_full_width():
    """``layers`` (``--layers``) keeps the first N layers of a config at
    its widths: Mixtral-8x22B's reduced widths here, one layer."""
    res = serve.main(["--arch", "mixtral_8x22b", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "9", "--gen-len", "3", "--layers", "1"])
    assert res["tokens"].shape == (1, 3)
    again = serve.serve("mixtral_8x22b", batch=1, prompt_len=9, gen_len=3, seed=0,
                        device="cpu", layers=1)
    assert np.array_equal(again["tokens"], res["tokens"])
    two = serve.serve("mixtral_8x22b", batch=1, prompt_len=9, gen_len=3, seed=0, device="cpu")
    assert two["tokens"].shape == (1, 3)


# ---------------------------------------------------------------------------
# Hygiene
# ---------------------------------------------------------------------------


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), SRC)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.kernels._build" in mods
    assert "repro_torch.launch.train_dssfn" in mods and "repro_torch.core.admm" in mods
    assert "repro_torch.launch.serve" in mods and "repro_torch.models.transformer" in mods
    assert "repro_torch.kernels.flash_attention.kernel" in mods and "repro_torch.configs" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_port_source_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)\b(?!_torch))", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(path)
    assert offenders == []


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: non-zero exit and no result line on stdout.  (On a card
    the script runs the full smoke instead, so the check stops here.)"""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
