"""The pieces that make the clip-folded Stage 2 round each clip as its
own fit does on the card, on the CPU: the translation's gradient summed
in a fixed order (`smplx._sum_rows`, `smplx._Translate`), the markers'
rotation as elementwise products (`amass_temp._rotate`), and
`conv_ae.conv2d(per_sample=True)` leaving a CPU batch whole."""

import numpy as np
import torch
import torch.nn.functional as F

from lemo_tpu_torch.body_model import smplx
from lemo_tpu_torch.fitting import amass_temp as s2
from lemo_tpu_torch.priors import conv_ae


def _rand(*shape, seed=0):
    return torch.as_tensor(np.random.RandomState(seed).randn(*shape)
                           .astype(np.float32))


def test_sum_rows_is_each_frames_own_sum():
    g = _rand(7, 1000, 3)
    out = smplx._sum_rows(g)
    assert out.shape == (7, 3)
    for b in range(7):
        assert torch.equal(out[b], smplx._sum_rows(g[b:b + 1])[0])
        assert torch.equal(out[b], smplx._sum_rows(g[[b, 0, 3]])[0])
    ref = g.double().sum(1)
    np.testing.assert_allclose(out.double().numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_translate_matches_the_broadcast_add():
    v, j, t = _rand(5, 300, 3, seed=1), _rand(5, 40, 3, seed=2), \
        _rand(5, 3, seed=3)
    gv, gj = _rand(5, 300, 3, seed=4), _rand(5, 40, 3, seed=5)
    leaves = [x.clone().requires_grad_(True) for x in (v, j, t)]
    ov, oj = smplx._Translate.apply(*leaves)
    assert torch.equal(ov, v + t[:, None]) and torch.equal(oj, j + t[:, None])
    dv, dj, dt = torch.autograd.grad((ov * gv).sum() + (oj * gj).sum(),
                                     leaves)
    assert torch.equal(dv, gv) and torch.equal(dj, gj)
    ref = (gv.double().sum(1) + gj.double().sum(1)).numpy()
    np.testing.assert_allclose(dt.double().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


def test_rotate_matches_the_product():
    x, R = _rand(4, 9, 81, 3, seed=6), _rand(4, 3, 3, seed=7)
    out = s2._rotate(x, R[:, None, None])
    np.testing.assert_allclose(out.numpy(), torch.matmul(x, R[:, None])
                               .numpy(), rtol=1e-5, atol=1e-6)
    one = s2._rotate(x[1], R[1])
    assert torch.equal(one, out[1])


def test_per_sample_conv_keeps_a_cpu_batch_whole():
    x, w, b = _rand(3, 2, 9, 11, seed=8), _rand(4, 2, 3, 3, seed=9), \
        _rand(4, seed=10)
    assert torch.equal(conv_ae.conv2d(x, w, b, per_sample=True),
                       F.conv2d(x, w, b, padding=(1, 1)))
