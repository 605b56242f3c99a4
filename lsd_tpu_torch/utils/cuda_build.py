"""Build a CUDA source of ``lsd_tpu_torch/csrc`` into a shared library and load it.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``lsd_tpu_torch/_build/`` (listed in
``.gitignore``), in a directory keyed by a hash of the source, the headers of
``csrc`` and the flags, and loaded with ``ctypes``.  Nothing is built when a module is imported.
The first build may happen on any thread (a pipeline module's, a mapper's
graph worker): ``load`` lets one thread of a process build and load a
library while the others wait for it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
    """Where ``csrc/<name>.cu`` is built for its current source, the
    current headers of ``csrc`` and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    (out.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_LOAD_LOCK = threading.Lock()
_loaded = set()          # the names this process has loaded


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process,
    one thread at a time."""
    with _LOAD_LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    _loaded.add(name)
    return lib


class LaunchCount:
    """The launches of the kernel of ``csrc/<name>.cu``, counted where it
    runs: its first thread adds one to a counter in device memory
    (``csrc/launch_count.cuh``), so a launch captured in a CUDA graph counts
    at every replay and not at the capture.  ``read`` and ``reset`` wait
    for the device; a library this process has not loaded has launched
    nothing, and is neither built nor loaded to say so."""

    def __init__(self, name: str):
        self.name = name

    def read(self, device=None, reset: bool = False) -> int:
        """The launches on ``device`` (the current one by default) since
        the last reset; zeroes them after when ``reset``."""
        if self.name not in _loaded:
            return 0
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: launches are counted on CUDA devices, not {dev}")
        fn = getattr(load(self.name), f"{self.name}_launch_count")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
        count = ctypes.c_ulonglong(0)
        err = fn(torch.cuda.current_device() if dev.index is None else dev.index,
                 1 if reset else 0, ctypes.byref(count))
        if err != 0:
            raise RuntimeError(f"{self.name}: reading the launch count failed with CUDA "
                               f"error {err}")
        return count.value

    def reset(self, device=None) -> None:
        """Zero the launches on ``device`` (the current one by default)."""
        self.read(device, reset=True)
