"""Build a CUDA source of ``lsd_tpu_torch/csrc`` into a shared library and load it.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``lsd_tpu_torch/_build/`` (listed in
``.gitignore``), in a directory keyed by a hash of the source and the flags,
and loaded with ``ctypes``.  Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; it is "
                           "needed to build the lsd_tpu_torch CUDA kernels")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built for its current source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    (out.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(str(build(name)))
