"""repro_torch.launch.serve_dssfn and the port's hygiene rules.

- The launcher serves a ``repro``-exported artifact end to end with
  ``--device cpu``, reports ``repro``'s result keys plus ``device`` and
  ``kernel_launches``, and its saved logits equal the engine's.
- Without ``--device`` it needs CUDA and says how to get the CPU.
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
from repro_torch.launch import serve_dssfn
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
