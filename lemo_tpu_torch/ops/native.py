"""ctypes bindings for the host C++ nearest-neighbour library (port of
`lemo_tpu/ops/native.py`).

`csrc/chamfer_cpu.cpp`, a byte-identical copy of `native/chamfer_cpu.cpp`,
is the CPU-native counterpart of the Chamfer kernel, for host-side data
tooling (the equivalent tier of the reference's external native ops: the
CUDA Chamfer extension, psbody's C++). It is compiled with the host C++
compiler on first use into `lemo_tpu_torch/_build/`
(`_build.build_host_library`). A failed build raises with the compiler's
message: no entry point gives way to numpy. `nn_distance_plain` is the
numpy version the tests hold the library against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from lemo_tpu_torch import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_host_library())
    lib.nn_distance_f32.argtypes = [_F32P, ctypes.c_int64, _F32P,
                                    ctypes.c_int64, _U8P, _F32P, _I32P]
    lib.chamfer_f32.argtypes = [_F32P, ctypes.c_int64, _F32P,
                                ctypes.c_int64, _F32P, _I32P, _F32P, _I32P]
    lib.nn_distance_grid_f32.argtypes = [_F32P, ctypes.c_int64, _F32P,
                                         ctypes.c_int64, ctypes.c_float,
                                         _F32P, _I32P]
    for fn in (lib.nn_distance_f32, lib.chamfer_f32,
               lib.nn_distance_grid_f32):
        fn.restype = None
    return lib


def available() -> bool:
    """Whether the library can be had here: False without a host C++
    compiler; otherwise it is built and loaded, and a failed build
    raises."""
    if not _build.host_toolchain_available():
        return False
    _load()
    return True


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def nn_distance_cpu(query: np.ndarray, points: np.ndarray,
                    mask: np.ndarray | None = None,
                    use_grid: bool = False):
    """(dist2 [N] f32, idx [N] int32): each query's squared distance to,
    and index of, its nearest point (among those `mask` keeps). With
    `use_grid` and no mask, the voxel-grid search."""
    q, p = _as_f32(query), _as_f32(points)
    n, m = len(q), len(p)
    lib = _load()
    dist = np.empty(n, np.float32)
    idx = np.empty(n, np.int32)
    if use_grid and mask is None:
        lib.nn_distance_grid_f32(
            q.ctypes.data_as(_F32P), n, p.ctypes.data_as(_F32P), m,
            ctypes.c_float(0.0), dist.ctypes.data_as(_F32P),
            idx.ctypes.data_as(_I32P))
    else:
        mask_arr = (np.ascontiguousarray(mask, np.uint8)
                    if mask is not None else None)
        lib.nn_distance_f32(
            q.ctypes.data_as(_F32P), n, p.ctypes.data_as(_F32P), m,
            mask_arr.ctypes.data_as(_U8P) if mask_arr is not None
            else ctypes.cast(None, _U8P),
            dist.ctypes.data_as(_F32P), idx.ctypes.data_as(_I32P))
    return dist, idx


def chamfer_cpu(a: np.ndarray, b: np.ndarray):
    """Bidirectional Chamfer on the host: (dist_a, dist_b, idx_a, idx_b)."""
    da, ia = nn_distance_cpu(a, b)
    db, ib = nn_distance_cpu(b, a)
    return da, db, ia, ib


def nn_distance_plain(query: np.ndarray, points: np.ndarray,
                      mask: np.ndarray | None = None):
    """numpy brute force with `nn_distance_cpu`'s contract (the tests'
    reference; inf and index 0 where no point is valid)."""
    q, p = _as_f32(query), _as_f32(points)
    n, m = len(q), len(p)
    dist = np.full(n, np.inf, np.float32)
    idx = np.zeros(n, np.int32)
    valid = np.ones(m, bool) if mask is None else np.asarray(mask, bool)
    pv = p[valid]
    if not len(pv):
        return dist, idx
    remap = np.flatnonzero(valid)
    for s in range(0, n, 512):
        d = ((q[s:s + 512, None] - pv[None]) ** 2).sum(-1)
        loc = d.argmin(1)
        dist[s:s + 512] = d[np.arange(len(loc)), loc]
        idx[s:s + 512] = remap[loc]
    return dist, idx
