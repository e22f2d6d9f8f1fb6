"""Builds the port's CUDA kernels and its host C++ library, and binds them
with ctypes.

`lemo_tpu_torch/csrc/*.cu` are compiled on first use with `nvcc` for
`sm_90a` (one object per source, all compiled in parallel) and linked
into one shared library with a plain C interface. The library lands in
`lemo_tpu_torch/_build/` (git-ignored) under a name keyed by the hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing here runs at import time: the CPU-only tests
import every module, and only a CUDA tensor reaches `load_library`.

The host libraries (`csrc/chamfer_cpu.cpp`, the nearest-neighbour and
Chamfer search on the CPU that `ops/native.py` binds; `csrc/jpeg_cpu.cpp`,
the JPEG decoder that `data/jpeg.py` binds) are compiled the same way
with the host C++ compiler (`build_host_library(source=...)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("chain.cu", "vertex.cu", "chamfer.cu", "intersection.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every entry point returns an int: the
# launches return their cudaGetLastError(), `lemo_vertex_bwd_slices` 0
# once it has written the backward's scratch extents (the split-K slice
# counts its own tiling gives) into its int[2]
SIGNATURES = {
    "lemo_chain_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
    "lemo_chain_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "lemo_chain_affine_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "lemo_chain_affine_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _P],
    "lemo_vertex_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lemo_vertex_blend": [_P, _P, _P, _I, _I, _I, _P],
    "lemo_vertex_fwd_apply": [_P, _P, _P, _P, _I, _I, _I, _P],
    "lemo_vertex_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
    "lemo_vertex_bwd_from_vs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P],
    "lemo_vertex_bwd_slices": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "lemo_vertex_bwd_pointwise": [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _P],
    "lemo_vertex_bwd_dcat": [_P, _P, _P, _P, _I, _I, _I, _P],
    "lemo_vertex_bwd_da2": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lemo_nn_select": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "lemo_cone_energy": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
}


HOST_SOURCE = os.path.join(CSRC, "chamfer_cpu.cpp")
HOST_FLAGS = ["-O3", "-shared", "-fPIC"]


def _host_cxx() -> str | None:
    """The host C++ compiler: $CXX, else g++, else c++ (None if absent)."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def host_toolchain_available() -> bool:
    return _host_cxx() is not None


def build_host_library(source: str = HOST_SOURCE,
                       build_dir: str = BUILD_DIR) -> str:
    """Compile (if needed) `source` with the host C++ compiler into a
    shared library under `build_dir`, named by the hash of the source and
    flags; returns its path. Raises with the compiler's message when the
    build fails, and when there is no compiler."""
    with open(source, "rb") as fh:
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + fh.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cxx = _host_cxx()
    if cxx is None:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) found; "
                           f"{source} cannot be built")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        so_tmp = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *HOST_FLAGS, source, "-o", so_tmp],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{cxx} failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so_tmp, path)
    return path


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"liblemo_kernels_{h.hexdigest()[:16]}.so")


def build_library(verbose: bool = False) -> tuple[str, float]:
    """Compile (if needed) and return (path of the .so, seconds spent
    building; 0.0 when it was already built). `verbose` adds ptxas's
    register/shared-memory report to the printed compiler output."""
    path = _lib_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC, name),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            out, _ = proc.communicate()
            if verbose or proc.returncode:
                print(f"[nvcc {name}]\n{out}", flush=True)
            if proc.returncode:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        so_tmp = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", so_tmp],
                       check=True)
        os.replace(so_tmp, path)
    return path, time.perf_counter() - t0


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.lemo_error_string.argtypes = [ctypes.c_int]
    lib.lemo_error_string.restype = ctypes.c_char_p
    return lib


def check_operand(name: str, t, dtype, shapes) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` with one of
    `shapes`: what a kernel's wrapper checks before it launches."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) not in [tuple(s) for s in shapes]:
        raise ValueError(f"{name}: shape {tuple(t.shape)} not in {shapes}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib.lemo_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
