"""A CUDA source of `lemo_tpu_torch/csrc/` on the CPU: compiled by the host
C++ compiler under a small emulation of the CUDA it uses, and bound
through its C entry points (the `_build.SIGNATURES` argument lists).
The CPU tests drive the kernels this way on machines with neither nvcc
nor a card.

The emulation runs a launch's blocks one after another and each block's
threads as `std::thread`s; `__syncthreads` is a `std::barrier`, a
`__shared__` variable a `static` one (one block at a time), dynamic shared
memory a buffer sized at the launch, and the rounding intrinsics
(`__fmaf_rn`, `__fmul_rn`, ...) their IEEE single operations. The warp
intrinsics (`__ballot_sync`, `__shfl_up_sync`) meet the 32 threads of a
warp at a per-warp barrier around a per-warp exchange buffer, so every
thread of the warp must call them, as on the card. It checks
the kernels' indexing (tiles, schedules, scratch layouts) and their C
interface, not their speed. Tiny shapes only: every thread is an OS
thread.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

from lemo_tpu_torch import _build

CUDA_EMULATION = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
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
#define CUDART_INF_F std::numeric_limits<float>::infinity()
struct EmuWarp {
  std::barrier<> bar;
  unsigned slot[32] = {};
  explicit EmuWarp(int n) : bar(n) {}
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline unsigned emu_lane() { return threadIdx.x % 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __ballot_sync(unsigned mask, int pred) {
  emu_warp->slot[emu_lane()] = pred ? 1u : 0u;
  emu_warp->bar.arrive_and_wait();
  unsigned b = 0;
  for (unsigned l = 0; l < 32; ++l)
    if ((mask >> l) & 1u) b |= emu_warp->slot[l] << l;
  emu_warp->bar.arrive_and_wait();
  return b;
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static_assert(sizeof(T) == sizeof(unsigned), "32-bit shuffles only");
  const unsigned lane = emu_lane();
  std::memcpy(&emu_warp->slot[lane], &v, sizeof(T));
  emu_warp->bar.arrive_and_wait();
  T out = v;
  if (lane >= delta) std::memcpy(&out, &emu_warp->slot[lane - delta], sizeof(T));
  emu_warp->bar.arrive_and_wait();
  return out;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
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
        std::vector<std::unique_ptr<EmuWarp>> warps;
        for (int w = 0; w * 32 < nt; ++w)
          warps.push_back(std::make_unique<EmuWarp>(std::min(32, nt - 32 * w)));
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            emu_warp = warps[t / 32].get();
            body();
          });
        for (auto& th : threads) th.join();
      }
}
"""


def emulated_source(cuda: str) -> str:
    """The CUDA source rewritten for the emulation header."""
    src = cuda.replace("#include <cuda_runtime.h>",
                       '#include "cuda_emulation.h"')
    src = src.replace("#include <math_constants.h>\n", "")
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = emu_dynamic_smem;", src)
    # kernel<<<config>>>(args); -> emu_launch([&] { kernel(args); }, config);
    return re.sub(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu_launch([&] {{ {m.group(1)}({m.group(3)}); "
                            f"}}, {m.group(2)});", src, flags=re.S)


def have_compiler() -> bool:
    return shutil.which("g++") is not None


def with_constants(text: str, constants: dict[str, int]) -> str:
    """`text` with each `constexpr int NAME = <value>;` of `constants` set
    to the given value (a source variant); raises unless each is defined
    once."""
    for name, value in constants.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"the source does not define {name} once")
    return text


def build_emulated(source: str, out_dir: str,
                   constants: dict[str, int] | None = None) -> ctypes.CDLL:
    """Compile `csrc/<source>` under the emulation into `out_dir` and bind
    the `_build.SIGNATURES` entry points it defines; `constants` builds a
    variant (`with_constants`)."""
    stem = os.path.splitext(source)[0]
    with open(os.path.join(_build.CSRC, source)) as fh:
        text = with_constants(fh.read(), constants or {})
    cpp = os.path.join(out_dir, f"{stem}.cpp")
    with open(cpp, "w") as fh:
        fh.write(emulated_source(text))
    with open(os.path.join(out_dir, "cuda_emulation.h"), "w") as fh:
        fh.write(CUDA_EMULATION)
    so = os.path.join(out_dir, f"lib{stem}_emulated.so")
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-fPIC",
                    "-shared", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    cpp, "-o", so, "-lpthread"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES.items():
        if re.search(rf"\b{fn}\(", text):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib
