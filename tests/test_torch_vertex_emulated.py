"""csrc/vertex.cu on the CPU: the CUDA source compiled by the host C++
compiler under a small emulation of the CUDA it uses, driven through its
C entry points (the `_build.SIGNATURES` argument lists) against the plain
twins of lemo_tpu_torch.body_model.vertex_cuda.

The emulation runs a launch's blocks one after another and each block's
threads as `std::thread`s; `__syncthreads` is a `std::barrier`, a
`__shared__` array a `static` one (one block at a time), dynamic shared
memory a buffer sized at the launch. It checks the kernels' indexing
(tiles, half tiles, split-K slices, scratch layouts) and their C
interface, not their speed or the card's rounding: the plain twins are
held at the kernels' own tolerances. Tiny shapes only: every thread is
an OS thread."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lemo_tpu_torch import _build
from lemo_tpu_torch.body_model import vertex_cuda as TV

CUDA_EMULATION = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline float* emu_dynamic_smem = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
inline void emu_launch(std::function<void()> body, dim3 grid, dim3 block,
                       size_t smem = 0, void* = nullptr) {
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  std::vector<float> dynamic(smem / sizeof(float) + 4);
  emu_dynamic_smem = dynamic.data();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nt);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            body();
          });
        for (auto& th : threads) th.join();
      }
}
"""


def _emulated_source(cuda: str) -> str:
    """The CUDA source rewritten for the emulation header."""
    src = cuda.replace("#include <cuda_runtime.h>",
                       '#include "cuda_emulation.h"')
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = emu_dynamic_smem;", src)
    # kernel<<<config>>>(args); -> emu_launch([&] { kernel(args); }, config);
    return re.sub(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu_launch([&] {{ {m.group(1)}({m.group(3)}); "
                            f"}}, {m.group(2)});", src, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to compile the emulated kernels")
    tmp = tmp_path_factory.mktemp("vertex_emulated")
    with open(f"{_build.CSRC}/vertex.cu") as fh:
        (tmp / "vertex.cpp").write_text(_emulated_source(fh.read()))
    (tmp / "cuda_emulation.h").write_text(CUDA_EMULATION)
    so = tmp / "libvertex_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-Wno-unknown-pragmas", str(tmp / "vertex.cpp"), "-o",
                    str(so), "-lpthread"], check=True, capture_output=True)
    handle = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        if fn.startswith("lemo_vertex"):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    return handle


def _operands(D, Jp, Vp, Bp, B, seed):
    rng = np.random.RandomState(seed)
    catT = np.zeros((D, Bp), np.float32)
    catT[:, :B] = rng.randn(D, B) * 0.3
    catT[-1, :B] = 1.0
    A2 = np.zeros((12, Jp, Bp), np.float32)
    A2[:, :, :B] = rng.randn(12, Jp, B) * 0.5
    dirs = rng.randn(3, Vp, D).astype(np.float32) * 0.1
    w = rng.dirichlet(np.ones(Jp), Vp).astype(np.float32)
    dout = rng.randn(3, Vp, Bp).astype(np.float32)
    return tuple(torch.as_tensor(x) for x in (catT, A2, dirs, w, dout))


def _empty(*shape):
    return torch.empty(shape, dtype=torch.float32)


def _p(t):
    return t.data_ptr()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# D odd (rows of dirs not 16-byte aligned), Jp below a float4 multiple of
# the tile, Bp a whole 64-frame tile or one and a half
SHAPES = [(21, 56, 128, 128, 100), (13, 8, 64, 96, 70)]


@pytest.mark.parametrize("shape", SHAPES, ids=["Bp128", "Bp96"])
def test_emulated_forward_matches_plain(lib, shape):
    """The forward in one C call (blend into the caller's scratch, then
    the apply), and each stage's own entry point, against the plain
    twins at the forward's 1e-5 m."""
    D, Jp, Vp, Bp, B = shape
    catT, A2, dirs, w, _ = _operands(*shape, seed=sum(shape))
    vs, out = _empty(3, Vp, Bp), _empty(3, Vp, Bp)
    assert lib.lemo_vertex_fwd(_p(catT), _p(A2), _p(dirs), _p(w), _p(vs),
                               _p(out), D, Jp, Vp, Bp, None) == 0
    ref_vs = TV.vertex_plain_blend(catT, dirs)
    assert float((vs - ref_vs).abs().max()) < 1e-5
    assert float((out - TV.vertex_plain_fwd(catT, A2, dirs, w)).abs().max()
                 ) < 1e-5
    blend, apply = _empty(3, Vp, Bp), _empty(3, Vp, Bp)
    assert lib.lemo_vertex_blend(_p(catT), _p(dirs), _p(blend), D, Vp, Bp,
                                 None) == 0
    assert lib.lemo_vertex_fwd_apply(_p(ref_vs), _p(A2), _p(w), _p(apply),
                                     Jp, Vp, Bp, None) == 0
    assert torch.equal(blend, vs)
    assert float((apply - TV.vertex_plain_fwd_apply(ref_vs, A2, w)).abs()
                 .max()) < 1e-5


def test_emulated_backward_from_kept_blend(lib):
    """The whole backward against the plain twin (rel 5e-5), and the
    backward from the forward's blend, to the bit."""
    D, Jp, Vp, Bp, B = SHAPES[1]
    catT, A2, dirs, w, dout = _operands(*SHAPES[1], seed=7)
    slices = (ctypes.c_int * 2)()
    assert lib.lemo_vertex_bwd_slices(D, Jp, Vp, Bp, slices) == 0
    vs = _empty(3, Vp, Bp)
    assert lib.lemo_vertex_blend(_p(catT), _p(dirs), _p(vs), D, Vp, Bp,
                                 None) == 0

    def backward(kept):
        dcat, da2 = _empty(D, Bp), _empty(12, Jp, Bp)
        scratch, dvs = _empty(3, Vp, Bp), _empty(3, Vp, Bp)
        pd, pa = _empty(slices[0], D, Bp), _empty(slices[1], 12, Jp, Bp)
        tail = (_p(dcat), _p(da2), _p(vs if kept else scratch), _p(dvs),
                _p(pd), _p(pa), D, Jp, Vp, Bp, None)
        if kept:
            rc = lib.lemo_vertex_bwd_from_vs(_p(A2), _p(dirs), _p(w),
                                             _p(dout), *tail)
        else:
            rc = lib.lemo_vertex_bwd(_p(catT), _p(A2), _p(dirs), _p(w),
                                     _p(dout), *tail)
        assert rc == 0
        return dcat, da2

    formed, kept = backward(False), backward(True)
    for got, again, ref in zip(formed, kept, TV.vertex_plain_bwd(
            catT, A2, dirs, w, dout)):
        assert _rel(got, ref) < 5e-5
        assert torch.equal(got, again)


@pytest.mark.parametrize("bad", ["Vp", "Bp", "Jp"])
def test_emulated_entry_points_refuse_shapes(lib, bad):
    """Shapes that are not whole tiles are refused before any launch."""
    D, Jp, Vp, Bp = 13, 8, 64, 96
    D, Jp, Vp, Bp = {"Vp": (D, Jp, Vp + 8, Bp), "Bp": (D, Jp, Vp, Bp + 8),
                     "Jp": (D, 72, Vp, Bp)}[bad]
    slices = (ctypes.c_int * 2)()
    assert lib.lemo_vertex_bwd_slices(D, Jp, Vp, Bp, slices) != 0
    assert lib.lemo_vertex_fwd(None, None, None, None, None, None, D, Jp, Vp,
                               Bp, None) != 0
