"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
first use into ``lib<name>-<hash>.so`` with ``nvcc`` for Hopper
(``sm_90a``), then loaded with ``ctypes``.  The libraries go to
``_build/`` beside this module, or, where the package directory cannot
be written (an installed, read-only package), to the user's cache,
``$XDG_CACHE_HOME/repro_torch/kernels`` (default ``~/.cache``).  The
hash covers every source under ``csrc/`` and the flags, so an edited
kernel is rebuilt and a stale library is never loaded.  Importing this module needs no ``nvcc``:
nothing is compiled before the first CUDA launch (or an explicit
:func:`build_all`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built on a host with the CUDA toolkit"
    )


def _writable(directory: Path) -> bool:
    """Whether ``directory`` exists or can be made, and can be written."""
    try:
        directory.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return os.access(directory, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """Where the libraries go: :data:`BUILD_DIR` when it can be written,
    else the per-user cache directory."""
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch" / "kernels"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of the sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at
    once.  Raises ``RuntimeError`` carrying nvcc's stderr on failure."""
    names = kernel_names() if names is None else names
    libs = {name: library_path(name) for name in names}
    for directory in {lib.parent for lib in libs.values()}:
        directory.mkdir(parents=True, exist_ok=True)
    procs = {}
    nvcc = None
    for name, lib in libs.items():
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])  # publish whole libraries only
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(str(build_all([name])[name]))
