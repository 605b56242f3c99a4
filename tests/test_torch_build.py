"""The port's kernel build helper (``lsd_tpu_torch/utils/cuda_build.py``)
on a machine without ``nvcc``: where a build goes, and that a build that
cannot start fails loudly and leaves nothing behind."""
import pytest

from lsd_tpu_torch.utils import cuda_build


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    base = cuda_build.library_path("p2p_reduce")
    assert base.parent.parent == cuda_build.BUILD_DIR and base.name == "libp2p_reduce.so"
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    paths = set()
    for body in ("int a;", "int b;"):
        (tmp_path / "p2p_reduce.cu").write_text(body)
        paths.add(cuda_build.library_path("p2p_reduce"))
    assert len(paths) == 2 and base not in paths


def test_build_without_nvcc_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("p2p_reduce")
    assert not (tmp_path / "build").exists()


def test_library_path_is_keyed_by_the_headers(tmp_path, monkeypatch):
    """A library is built anew when a header of ``csrc`` changes, such as
    ``launch_count.cuh``, which every kernel includes."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "p2p_reduce.cu").write_text('#include "launch_count.cuh"')
    paths = set()
    for body in ("int a;", "int b;"):
        (tmp_path / "launch_count.cuh").write_text(body)
        paths.add(cuda_build.library_path("p2p_reduce"))
    assert len(paths) == 2


def test_launch_count_of_a_library_never_loaded_is_zero(monkeypatch):
    """A kernel whose library this process has not loaded has launched
    nothing: its count reads 0 and resets without building or loading it."""
    monkeypatch.setattr(cuda_build, "_loaded", set())
    monkeypatch.setattr(cuda_build, "build", lambda name: pytest.fail(f"built {name}"))
    count = cuda_build.LaunchCount("p2p_reduce")
    assert count.read() == 0
    count.reset()
    assert count.read("cuda:3") == 0
