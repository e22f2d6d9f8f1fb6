"""csrc/vertex.cu on the CPU: the CUDA source compiled by the host C++
compiler under the emulation of `lemo_tpu_torch.testing.cuda_emulation`,
driven through its C entry points (the `_build.SIGNATURES` argument
lists) against the plain twins of lemo_tpu_torch.body_model.vertex_cuda.

It checks the kernels' indexing (tiles, half tiles, split-K slices,
scratch layouts) and their C interface, not their speed or the card's
rounding: the plain twins are held at the kernels' own tolerances."""

import ctypes

import numpy as np
import pytest
import torch

from lemo_tpu_torch.body_model import vertex_cuda as TV
from lemo_tpu_torch.testing import cuda_emulation


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_emulation.have_compiler():
        pytest.skip("needs g++ (C++20) to compile the emulated kernels")
    return cuda_emulation.build_emulated(
        "vertex.cu", str(tmp_path_factory.mktemp("vertex_emulated")))


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
