"""The port's host C++ nearest-neighbour library (`ops/native.py`) against
lemo_tpu's (`lemo_tpu/ops/native.py`) and the numpy version, at
tests/test_native.py's tolerances (rtol 1e-5, atol 1e-6; the brute-force
indices equal). The port builds its own byte-identical copy of the
source into its build directory and raises when the build fails."""

import filecmp
import os

import numpy as np
import pytest

from lemo_tpu.ops import native as J
from lemo_tpu_torch import _build
from lemo_tpu_torch.ops import native as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(44)


def test_source_is_a_byte_identical_copy():
    assert filecmp.cmp(os.path.join(REPO, "native", "chamfer_cpu.cpp"),
                       _build.HOST_SOURCE, shallow=False)


def test_builds_into_the_port_build_dir():
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    assert T.available()
    path = _build.build_host_library()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libchamfer_cpu_")
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


@pytest.mark.parametrize("use_grid", [False, True])
def test_nn_matches_lemo_tpu_and_plain(use_grid):
    q = RNG.randn(500, 3).astype(np.float32) * 2
    p = RNG.randn(3000, 3).astype(np.float32) * 2
    d, i = T.nn_distance_cpu(q, p, use_grid=use_grid)
    dj, ij = J.nn_distance_cpu(q, p, use_grid=use_grid)
    dp, ip = T.nn_distance_plain(q, p)
    assert d.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d, dp, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, ij)
    if not use_grid:
        np.testing.assert_array_equal(i, ip)


def test_mask_matches():
    q = RNG.randn(50, 3).astype(np.float32)
    p = RNG.randn(80, 3).astype(np.float32)
    mask = RNG.rand(80) < 0.5
    d, i = T.nn_distance_cpu(q, p, mask=mask)
    dj, ij = J.nn_distance_cpu(q, p, mask=mask)
    dp, ip = T.nn_distance_plain(q, p, mask=mask)
    assert mask[i].all()
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(i, ip)
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d, dp, rtol=1e-5, atol=1e-6)


def test_chamfer_matches():
    a = RNG.randn(100, 3).astype(np.float32)
    b = RNG.randn(150, 3).astype(np.float32)
    got, ref = T.chamfer_cpu(a, b), J.chamfer_cpu(a, b)
    for x, y in zip(got, ref):
        assert x.shape == y.shape
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message,
    and the entry points raise with it: nothing gives way to numpy."""
    bad = tmp_path / "chamfer_cpu.cpp"
    bad.write_text(open(_build.HOST_SOURCE).read() + "\nnot C++ at all;\n")
    with pytest.raises(RuntimeError, match="error"):
        _build.build_host_library(str(bad), str(tmp_path / "build"))
    real = _build.build_host_library
    monkeypatch.setattr(_build, "build_host_library", lambda: real(
        str(bad), str(tmp_path / "build")))
    T._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on"):
            T.nn_distance_cpu(np.zeros((2, 3)), np.zeros((3, 3)))
        with pytest.raises(RuntimeError, match="failed on"):
            T.available()
    finally:
        T._load.cache_clear()


def test_no_compiler_is_reported(tmp_path, monkeypatch):
    """Without a host compiler `available()` says so and a call raises."""
    monkeypatch.setattr(_build, "_host_cxx", lambda: None)
    real = _build.build_host_library
    monkeypatch.setattr(_build, "build_host_library", lambda: real(
        _build.HOST_SOURCE, str(tmp_path / "build")))
    T._load.cache_clear()
    try:
        assert not T.available()
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            T.nn_distance_cpu(np.zeros((2, 3)), np.zeros((3, 3)))
    finally:
        T._load.cache_clear()
