"""csrc/chain.cu on the CPU: the CUDA source compiled by the host C++
compiler under the emulation of `lemo_tpu_torch.testing.cuda_emulation`,
driven through its C entry points (the `_build.SIGNATURES` argument
lists) on the SMPL-X tree against the plain twins of
lemo_tpu_torch.body_model.chain_cuda.

The emulation rounds each operation as IEEE single precision, as the card
does, so it also holds the affine forward to the bit against the chain
forward with the eager ops around it, as `chip_smoke.py` does on the
card. Frames 1, 3 and 5: one block short of its frames, and two."""

import numpy as np
import pytest
import torch

from lemo_tpu_torch.body_model import chain_cuda as TC
from lemo_tpu_torch.ops.rotations import aa_to_matrot
from lemo_tpu_torch.testing import cuda_emulation
from lemo_tpu_torch.testing.synthetic import SMPLX_PARENTS

PARENTS = (0,) + tuple(int(p) for p in SMPLX_PARENTS[1:])     # J = 55
JP = 56
PADDED = PARENTS + (0,)
FRAMES = [1, 3, 5]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_emulation.have_compiler():
        pytest.skip("needs g++ (C++20) to compile the emulated kernels")
    return cuda_emulation.build_emulated(
        "chain.cu", str(tmp_path_factory.mktemp("chain_emulated")))


def _operands(B, seed):
    """rl (rotations of the model's joints, identity for the padding one),
    jr, tl from jr, and cotangents of every output."""
    rng = np.random.RandomState(seed)
    aa = torch.as_tensor(rng.randn(B, JP, 3).astype(np.float32) * 0.5)
    aa[:, len(PARENTS):] = 0
    rl = aa_to_matrot(aa).permute(2, 3, 1, 0).reshape(9, JP, B).contiguous()
    jr = torch.zeros(3, JP, B)
    jr[:, :len(PARENTS)] = torch.as_tensor(
        rng.randn(3, len(PARENTS), B).astype(np.float32) * 0.3)
    tl = torch.einsum("jp,npb->njb", TC._msub(PARENTS, JP, "cpu"), jr)
    cts = [torch.as_tensor(rng.randn(k, JP, B).astype(np.float32))
           for k in (9, 3, 12)]
    return rl, jr, tl.contiguous(), cts


def _empty(*shape):
    return torch.empty(shape, dtype=torch.float32)


def _p(t):
    return t.data_ptr()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _sched(parents):
    return TC._schedule_on(parents, "cpu")


def _fwd(lib, rl, tl):
    sched, nlev = _sched(PADDED)
    B = rl.shape[2]
    rg, tg = _empty(9, JP, B), _empty(3, JP, B)
    assert lib.lemo_chain_fwd(_p(sched), nlev, _p(rl), _p(tl), _p(rg), _p(tg),
                              JP, B, None) == 0
    return rg, tg


def _affine_fwd(lib, rl, jr):
    sched, nlev = _sched(PADDED)
    B = rl.shape[2]
    A, tg = _empty(12, JP, B), _empty(3, JP, B)
    assert lib.lemo_chain_affine_fwd(_p(sched), nlev, _p(rl), _p(jr), _p(A),
                                     _p(tg), len(PARENTS), JP, B, None) == 0
    return A, tg


@pytest.mark.parametrize("B", FRAMES)
def test_emulated_forward_matches_plain(lib, B):
    rl, _, tl, _ = _operands(B, seed=B)
    rg, tg = _fwd(lib, rl, tl)
    ref = TC.chain_planes_plain_fwd(rl, tl, PADDED)
    assert float((rg - ref[0]).abs().max()) < 1e-5
    assert float((tg - ref[1]).abs().max()) < 1e-5


@pytest.mark.parametrize("B", FRAMES)
def test_emulated_backward_matches_plain(lib, B):
    rl, _, tl, (drg, dtg, _) = _operands(B, seed=10 + B)
    rg, _ = _fwd(lib, rl, tl)
    sched, nlev = _sched(PADDED)
    drl, dtl = _empty(9, JP, B), _empty(3, JP, B)
    assert lib.lemo_chain_bwd(_p(sched), nlev, _p(rl), _p(tl), _p(rg),
                              _p(drg), _p(dtg), _p(drl), _p(dtl), JP, B,
                              None) == 0
    ref = TC.chain_planes_plain_bwd(rl, tl, rg, drg, dtg, PADDED)
    assert _rel(drl, ref[0]) < 5e-5
    assert _rel(dtl, ref[1]) < 5e-5


@pytest.mark.parametrize("B", FRAMES)
def test_emulated_affine_forward_is_the_unfused_path_to_the_bit(lib, B):
    """The affine forward against the chain forward on tl from the ±1
    matrix product, with the epilogue in eager ops: the same bits; and
    against the plain twin at 1e-5."""
    rl, jr, tl, _ = _operands(B, seed=20 + B)
    A, tg = _affine_fwd(lib, rl, jr)
    rg, tg_u = _fwd(lib, rl, tl)
    rel_t = torch.stack([tg_u[m] - (rg[3 * m] * jr[0] + rg[3 * m + 1] * jr[1]
                                    + rg[3 * m + 2] * jr[2])
                         for m in range(3)])
    assert torch.equal(A, torch.cat([rg, rel_t]))
    assert torch.equal(tg, tg_u)
    A_p, tg_p = TC.chain_affine_plain_fwd(rl, jr, PARENTS)
    assert float((A - A_p).abs().max()) < 1e-5
    assert float((tg - tg_p).abs().max()) < 1e-5


@pytest.mark.parametrize("B", FRAMES)
def test_emulated_affine_backward_matches_plain(lib, B):
    rl, jr, _, (_, dtg, dA) = _operands(B, seed=30 + B)
    A, _ = _affine_fwd(lib, rl, jr)
    sched, nlev = _sched(PADDED)
    drl, djr = _empty(9, JP, B), _empty(3, JP, B)
    assert lib.lemo_chain_affine_bwd(_p(sched), nlev, _p(rl), _p(jr), _p(A),
                                     _p(dA), _p(dtg), _p(drl), _p(djr),
                                     len(PARENTS), JP, B, None) == 0
    ref = TC.chain_affine_plain_bwd(rl, jr, A, dA, dtg, PARENTS)
    assert _rel(drl, ref[0]) < 5e-5
    assert _rel(djr, ref[1]) < 5e-5


@pytest.mark.parametrize("bad", ["joints", "levels", "J"])
def test_emulated_entry_points_refuse_shapes(lib, bad):
    """Past the static limits (64 joints, 16 levels), or J past Jp, the
    entry points refuse before any launch."""
    sched, nlev = _sched(PADDED)
    Jp, J = JP, len(PARENTS)
    if bad == "joints":
        Jp = 72
    elif bad == "levels":
        nlev = 17
    else:
        J = Jp + 1
    if bad != "J":
        assert lib.lemo_chain_fwd(_p(sched), nlev, None, None, None, None,
                                  Jp, 4, None) != 0
    assert lib.lemo_chain_affine_fwd(_p(sched), nlev, None, None, None, None,
                                     J, Jp, 4, None) != 0
