"""csrc/chamfer.cu on the CPU: the CUDA source compiled by the host C++
compiler under the emulation of `lemo_tpu_torch.testing.cuda_emulation`
(warps meet at a per-warp barrier for the mask ballots and the scan's
shuffles), driven through its C entry point `lemo_nn_select` against
`ops.chamfer.nn_select_plain`, the kernel's plain version. The emulation
rounds each operation as IEEE single precision, as the card does, so the
kernel's indices and distances must equal the plain version's bit for bit.

Builds: the source as it ships (2,048-point chunks, 128 threads of 2
queries), other query counts (4 and 8 a thread), one-warp blocks with
512-point chunks, and a small one (256-point chunks, 64 threads of 2
queries) whose chunks and query tiles are crossed by small clouds."""

import numpy as np
import pytest
import torch

from lemo_tpu_torch.ops import chamfer as ch
from lemo_tpu_torch.testing import cuda_emulation

BUILDS = {
    "as_shipped": {},
    "queries4": {"kQueries": 4},
    "queries8": {"kQueries": 8},
    "warp": {"kThreads": 32, "kChunk": 512},
    "small": {"kChunk": 256, "kThreads": 64, "kQueries": 2},
}
CHUNK = {"as_shipped": 2048, "queries4": 2048, "queries8": 2048,
         "warp": 512, "small": 256}


@pytest.fixture(scope="module", params=list(BUILDS))
def build(request, tmp_path_factory):
    if not cuda_emulation.have_compiler():
        pytest.skip("needs g++ (C++20) to compile the emulated kernels")
    name = request.param
    lib = cuda_emulation.build_emulated(
        "chamfer.cu", str(tmp_path_factory.mktemp(f"chamfer_{name}")),
        BUILDS[name])
    return lib, CHUNK[name]


def _select(lib, q, p, m):
    """The kernel's (idx, dmin) through `lemo_nn_select`, with the
    wrapper's recentring (`chamfer_cuda.nn_select_kernel`)."""
    T, N = q.shape[:2]
    M = p.shape[1]
    q, p = q.contiguous(), p.contiguous()
    center = q.mean(dim=1)
    idx = torch.empty((T, N), dtype=torch.int64)
    dmin = torch.empty((T, N), dtype=torch.float32)
    m = None if m is None else m.contiguous()
    rc = lib.lemo_nn_select(
        q.data_ptr(), p.data_ptr(), None if m is None else m.data_ptr(),
        center.data_ptr(), idx.data_ptr(), dmin.data_ptr(), T, N, M,
        int(p.shape[0] == T), int(m is not None and m.shape[0] == T), None)
    assert rc == 0
    return idx, dmin


def _same_bits(lib, q, p, m):
    idx, dmin = _select(lib, q, p, m)
    ref_i, ref_d = ch.nn_select_plain(q, p, m)
    assert torch.equal(idx, ref_i)
    assert torch.equal(dmin.view(torch.int32), ref_d.view(torch.int32))
    return idx, dmin


def _clouds(seed, T, N, M, Tp=None, scale=0.5, offset=(0.3, 1.2, 2.8)):
    """Scene-scale clouds (a camera-frame offset, as the depth terms see
    them); a query row of zeros at the end of each frame, like scan
    padding."""
    rng = np.random.RandomState(seed)
    off = np.float32(offset)
    q = (rng.randn(T, N, 3) * scale + off).astype(np.float32)
    q[:, -1] = 0.0
    p = (rng.randn(Tp or T, M, 3) * scale + off).astype(np.float32)
    return torch.as_tensor(q), torch.as_tensor(p), rng


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_emulated_matches_plain_bits(build, masked, shared):
    """Batched and shared [1, M, 3] clouds, masked and not; N not a
    multiple of any build's query tile, M across more than one chunk."""
    lib, chunk = build
    T, N, M = 3, 301, chunk + chunk // 2 + 7
    q, p, rng = _clouds(1 + masked + 2 * shared, T, N, M,
                        Tp=1 if shared else None)
    m = None
    if masked:
        m = torch.as_tensor(rng.rand(1 if shared else T, M) > 0.6)
    _same_bits(lib, q, p, m)


def test_emulated_empty_and_full_chunks(build):
    """Chunk 0 with no valid point, chunk 1 with all valid, the tail
    random; one frame with every point masked (+inf, index 0)."""
    lib, chunk = build
    T, N, M = 3, 130, 2 * chunk + 45
    q, p, rng = _clouds(7, T, N, M)
    m = torch.as_tensor(rng.rand(T, M) > 0.5)
    m[:, :chunk] = False
    m[:, chunk:2 * chunk] = True
    m[1] = False
    idx, dmin = _same_bits(lib, q, p, m)
    assert (idx[1] == 0).all() and torch.isinf(dmin[1]).all()
    assert (idx[0] >= chunk).all() and torch.isfinite(dmin[0]).all()


def test_emulated_ties_go_to_the_lowest_index(build):
    """Exact duplicates of each point in a later chunk and later in the
    same chunk, and queries on the points: every distance ties, and the
    lowest valid index must win, across chunks and within one."""
    lib, chunk = build
    T, base = 2, 40
    q, p0, rng = _clouds(11, T, 60, base)
    M = chunk + 2 * base
    p = torch.zeros((T, M, 3))
    p[:, :base] = p0
    p[:, base:2 * base] = p0                          # same chunk
    p[:, chunk:chunk + base] = p0                     # next chunk
    p[:, chunk + base:] = p0
    q[:, :base] = p0                                  # queries on points
    m = torch.zeros((T, M), dtype=torch.bool)
    m[:, :2 * base] = True
    m[:, chunk:] = True
    m[0, :base // 2] = False      # frame 0: the first copy half masked
    idx, _ = _same_bits(lib, q, p, m)
    on = idx[:, :base]
    k = torch.arange(base)
    assert torch.equal(on[1], k)
    assert torch.equal(on[0, base // 2:], k[base // 2:])
    assert torch.equal(on[0, :base // 2], k[:base // 2] + base)
    _same_bits(lib, q, p, None)


def test_emulated_small_and_single_query(build):
    """Fewer points than a warp's round and a single query a frame."""
    lib, _ = build
    q, p, rng = _clouds(13, 2, 1, 5)
    _same_bits(lib, q, p, torch.as_tensor(rng.rand(2, 5) > 0.3))
    _same_bits(lib, q, p, None)
