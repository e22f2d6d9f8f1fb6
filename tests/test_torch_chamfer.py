"""The port's nearest-neighbour search (`lemo_tpu_torch.ops.chamfer`)
against `lemo_tpu.ops.chamfer.nn_distance` and the Pallas kernel in
interpret mode, on the CPU (where the port runs its plain version).
Tolerances are those of tests/test_chamfer_pallas.py: d2 at rtol 1e-4,
atol 1e-5 (the expanded form and the exact re-derivation differ by f32
rounding), idx equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.ops.chamfer import chamfer_distance as j_chamfer
from lemo_tpu.ops.chamfer import nn_distance as j_nn
from lemo_tpu.ops.chamfer_pallas import nn_distance_pallas
from lemo_tpu_torch.ops import chamfer as tc
from lemo_tpu_torch.ops import chamfer_cuda

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _clouds(seed, n, m, offset=0.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n, 3) * 0.5 + offset).astype(np.float32)
    p = (rng.randn(m, 3) * 0.5 + offset).astype(np.float32)
    return q, p


def _check(out, ref):
    d2, idx = out
    rd2, ridx = ref
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("offset", [0.0, 3.0])
@pytest.mark.parametrize("masked", [False, True])
def test_nn_distance_matches_jax_and_pallas(offset, masked):
    q, p = _clouds(0, 300, 500, offset)
    mask = (np.random.RandomState(1).rand(500) > 0.3) if masked else None
    out = tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p),
                         None if mask is None else torch.as_tensor(mask))
    jm = None if mask is None else jnp.asarray(mask)
    _check(out, j_nn(jnp.asarray(q), jnp.asarray(p), jm))
    _check(out, nn_distance_pallas(jnp.asarray(q), jnp.asarray(p), jm,
                                   interpret=True))


def test_all_masked_frame_gives_index_zero():
    q, p = _clouds(2, 40, 64)
    mask = np.zeros(64, bool)
    d2, idx = tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p),
                             torch.as_tensor(mask))
    assert (idx == 0).all()
    np.testing.assert_allclose(d2.numpy(), ((q - p[0]) ** 2).sum(-1),
                               rtol=1e-6)
    ref = j_nn(jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask))
    _check((d2, idx), ref)
    _, dmin = tc.nn_select_plain(torch.as_tensor(q)[None],
                                 torch.as_tensor(p)[None],
                                 torch.as_tensor(mask)[None])
    assert torch.isinf(dmin).all()


@pytest.mark.parametrize("shared", [False, True])
def test_batched_frames_match_per_frame_loop(shared):
    T, N, M = 5, 120, 200
    rng = np.random.RandomState(3)
    q = (rng.randn(T, N, 3) * 0.4 + [0.0, 1.0, 3.0]).astype(np.float32)
    p = (rng.randn(M, 3) if shared else rng.randn(T, M, 3)).astype(
        np.float32) * 0.4 + np.float32([0.0, 1.0, 3.0])
    mask = None if shared else rng.rand(T, M) > 0.25
    if mask is not None:
        mask[2] = False                        # one frame with no point
    d2, idx = tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p),
                             None if mask is None else torch.as_tensor(mask))
    assert d2.shape == (T, N) and idx.shape == (T, N)
    for t in range(T):
        pt = p if shared else p[t]
        mt = None if mask is None else mask[t]
        ref = j_nn(jnp.asarray(q[t]), jnp.asarray(pt),
                   None if mt is None else jnp.asarray(mt))
        _check((d2[t], idx[t]), ref)
        single = tc.nn_distance(torch.as_tensor(q[t]), torch.as_tensor(pt),
                                None if mt is None else torch.as_tensor(mt))
        np.testing.assert_array_equal(single[1].numpy(), idx[t].numpy())
        np.testing.assert_array_equal(single[0].numpy(), d2[t].numpy())


def test_plain_version_chunks_frames_and_points():
    """A block budget smaller than one frame forces the frame and point
    chunking; the answer is unchanged."""
    T, N, M = 3, 64, 5000
    rng = np.random.RandomState(4)
    q = torch.as_tensor(rng.randn(T, N, 3).astype(np.float32))
    p = torch.as_tensor(rng.randn(T, M, 3).astype(np.float32))
    full = tc.nn_select_plain(q, p, None)
    saved = tc._PLAIN_BLOCK
    tc._PLAIN_BLOCK = 1
    try:
        small = tc.nn_select_plain(q, p, None)
    finally:
        tc._PLAIN_BLOCK = saved
    np.testing.assert_array_equal(full[0].numpy(), small[0].numpy())
    np.testing.assert_array_equal(full[1].numpy(), small[1].numpy())


def test_ties_go_to_the_lowest_index():
    q = np.zeros((4, 3), np.float32)
    p = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
    _, idx = tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p))
    assert (idx == 0).all()
    _, idx = tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p),
                            torch.as_tensor([False, True, True, True]))
    assert (idx == 1).all()


def test_chamfer_distance_matches_jax():
    a, b = _clouds(5, 150, 180, 1.5)
    rng = np.random.RandomState(6)
    am, bm = rng.rand(150) > 0.2, rng.rand(180) > 0.2
    out = tc.chamfer_distance(torch.as_tensor(a), torch.as_tensor(b),
                              torch.as_tensor(am), torch.as_tensor(bm))
    ref = j_chamfer(jnp.asarray(a), jnp.asarray(b), jnp.asarray(am),
                    jnp.asarray(bm))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    for o, r in zip(out[2:], ref[2:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax(masked):
    q, p = _clouds(7, 90, 130, 2.0)
    mask = (np.random.RandomState(8).rand(130) > 0.3) if masked else None

    def jloss(qq, pp):
        d2, _ = j_nn(qq, pp, None if mask is None else jnp.asarray(mask))
        return d2.mean()

    gq, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    tq = torch.as_tensor(q).requires_grad_(True)
    tp = torch.as_tensor(p).requires_grad_(True)
    d2, _ = tc.nn_distance(tq, tp, None if mask is None
                           else torch.as_tensor(mask))
    d2.mean().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5,
                               atol=1e-8)


def test_cpu_tensors_never_reach_the_kernel():
    """The wrapper takes CUDA tensors only; a CPU tensor goes to the plain
    version, and the kernel's launch count stays untouched."""
    before = chamfer_cuda.launches["chamfer"]
    q, p = _clouds(9, 10, 20)
    tc.nn_distance(torch.as_tensor(q), torch.as_tensor(p))
    assert chamfer_cuda.launches["chamfer"] == before
    with pytest.raises(ValueError, match="CUDA"):
        chamfer_cuda.nn_select_kernel(torch.as_tensor(q)[None],
                                      torch.as_tensor(p)[None], None)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(10)
    q = torch.as_tensor(rng.randn(4, 700, 3).astype(np.float32) + 3.0,
                        device="cuda")
    p = torch.as_tensor(rng.randn(4, 2500, 3).astype(np.float32) + 3.0,
                        device="cuda")
    m = torch.as_tensor(rng.rand(4, 2500) > 0.2, device="cuda")
    ki, kd = chamfer_cuda.nn_select_kernel(q, p, m)
    pi, pd = tc.nn_select_plain(q, p, m)
    assert (ki == pi).float().mean().item() >= 0.9999
    assert (kd - pd).abs().max().item() <= 1e-6
