"""The port's package data ships every source its CUDA kernels build from.

``repro_torch`` compiles ``kernels/csrc/*.cu`` with nvcc at first use, so
an installed package (a wheel) must carry each ``.cu`` and every header a
``.cu`` or header includes with ``#include "..."``.  The globs are read
from ``pyproject.toml``'s ``[tool.setuptools.package-data]``, as
setuptools reads them.
"""
import re
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
CSRC = PKG / "kernels" / "csrc"
SOURCES = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _shipped() -> set[Path]:
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"]["repro_torch"]
    return {p.resolve() for pattern in globs for p in PKG.glob(pattern)}


def _includes(name: str) -> list[str]:
    return LOCAL_INCLUDE.findall((CSRC / name).read_text())


@pytest.mark.parametrize("name", SOURCES)
def test_source_and_its_local_includes_are_package_data(name):
    shipped = _shipped()
    assert (CSRC / name).resolve() in shipped, f"{name} is not in the package data"
    for header in _includes(name):
        path = (CSRC / header).resolve()
        assert path.exists(), f"{name} includes {header}, which does not exist"
        assert path in shipped, f"{name} includes {header}, which the package data leaves out"


def test_the_kernels_do_include_local_headers():
    """The check above has something to check: the Gram kernels share
    gram.cuh and flash_attention.cu takes its mma wrappers from
    tensor_core.cuh."""
    assert _includes("gram.cu") == ["gram.cuh"]
    assert "gram.cuh" in _includes("propagate_gram.cu")
    assert "tensor_core.cuh" in _includes("flash_attention.cu")


def test_a_glob_of_only_cu_files_would_fail(monkeypatch):
    """The package data before the headers were added, ``*.cu`` alone,
    leaves the headers out, and the check sees it."""
    monkeypatch.setattr(tomllib, "loads", lambda _: {"tool": {"setuptools": {
        "package-data": {"repro_torch": ["kernels/csrc/*.cu"]}}}})
    with pytest.raises(AssertionError, match="leaves out"):
        test_source_and_its_local_includes_are_package_data("gram.cu")
