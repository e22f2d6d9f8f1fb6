"""The clip-batched AMASS Stage 2 in the port vs lemo_tpu on the
400-vertex setup: the batched loss terms, the folded fit against
lemo_tpu's folded fit (C=3, T=12, S=5) at lemo_tpu's own tolerances, the
per-clip NaN freeze (exact), `vmap` against `fold`, and the per-clip
Adam engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.data import markers as j_markers
from lemo_tpu.data import segments as j_segments
from lemo_tpu.data.stats import GlobalStats as JStats
from lemo_tpu.fitting import amass_temp as j_s2
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting import adam as t_adam
from lemo_tpu_torch.fitting import amass_temp as t_s2

torch.set_num_threads(2)

C, T, S = 3, 12, 5
# lemo_tpu's tolerances for two forms of the same batched fit
# (tests/test_fitting_stage2.py:165-170)
X_RTOL, X_ATOL = 6e-2, 2e-3
L_RTOL, L_ATOL = 2e-3, 2e-5


@pytest.fixture(scope="module")
def setup():
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    jm = j_load(md, use_pca=True, num_pca_comps=12)
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(0)).items()}
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(1)).items()}
    stats = JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243))
    ids = (j_markers.marker_indices(False, num_verts=400),
           j_markers.marker_indices(True, num_verts=400),
           j_segments.foot_vertex_ids(num_verts=400))
    rng = np.random.RandomState(7)
    data = (rng.randn(C, T, 67, 3).astype(np.float32) * 0.2,
            (rng.rand(C, T, 4) > 0.5).astype(np.float32),
            rng.randn(C, T, 72).astype(np.float32) * 0.1)
    fold = j_s2.make_temporal_fitter_batched(jm, vpp, enc, stats, *ids,
                                             num_steps=S, impl="fold")
    x_ref, l_ref = fold(*(jnp.asarray(a) for a in data))
    port = tuple(from_numpy_tree(p, "cpu") for p in (vpp, enc, stats))
    return md, port, ids, data, (np.array(x_ref), np.array(l_ref))


def _fitter(md, port, ids, fused=False, impl="fold"):
    tm = t_load(md, use_pca=True, num_pca_comps=12, build_fused=fused,
                device="cpu")
    return t_s2.make_temporal_fitter_batched(tm, *port, *ids, num_steps=S,
                                             impl=impl, device="cpu")


@pytest.mark.parametrize("path", ["separate", "fused"])
def test_folded_fit_matches_lemo_tpu(setup, path):
    md, port, ids, data, (x_ref, l_ref) = setup
    x72, losses = _fitter(md, port, ids, fused=(path == "fused"))(*data)
    assert x72.shape == (C, T, 72) and losses.shape == (C, S)
    np.testing.assert_allclose(losses.numpy(), l_ref, rtol=L_RTOL,
                               atol=L_ATOL)
    np.testing.assert_allclose(x72.numpy(), x_ref, rtol=X_RTOL, atol=X_ATOL)
    np.testing.assert_array_equal(x72[..., 6:16].numpy(),
                                  data[2][..., 6:16])


def test_vmap_matches_fold(setup):
    md, port, ids, data, _ = setup
    xf, lf = _fitter(md, port, ids)(*data)
    xv, lv = _fitter(md, port, ids, impl="vmap")(*data)
    assert lv.shape == (C, S)
    np.testing.assert_allclose(lf.numpy(), lv.numpy(), rtol=L_RTOL,
                               atol=L_ATOL)
    np.testing.assert_allclose(xf.numpy(), xv.numpy(), rtol=X_RTOL,
                               atol=X_ATOL)


@pytest.mark.parametrize("path", ["separate", "fused"])
def test_folded_nan_freeze_is_per_clip(setup, path):
    """A clip whose loss goes non-finite freezes only itself: the healthy
    clips equal, bit for bit, the same batch fitted with that clip
    healthy, and the poisoned clip stays at its init."""
    md, port, ids, (target, contact, init72), _ = setup
    fit = _fitter(md, port, ids, fused=(path == "fused"))
    bad = target.copy()
    bad[0] = np.nan
    with torch.backends.cudnn.flags(deterministic=True):
        xb, lb = fit(bad, contact, init72)
        xg, lg = fit(target, contact, init72)
    np.testing.assert_allclose(xb[0].numpy(), init72[0], atol=1e-5)
    assert torch.isnan(lb[0]).all()
    assert torch.equal(xb[1:], xg[1:])
    assert torch.equal(lb[1:], lg[1:])
    assert torch.isfinite(lb[1:]).all()


def test_fused_false_raises(setup):
    md, port, ids, _, _ = setup
    tm = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    with pytest.raises(NotImplementedError, match="shard"):
        t_s2.make_temporal_fitter_batched(tm, *port, *ids, fused=False,
                                          device="cpu")


def test_batched_losses_match(setup):
    _, (_, enc_t, stats_t), (_, ids81, feet), _, _ = setup
    enc_j = {k: jnp.asarray(v.numpy()) for k, v in enc_t.items()}
    stats_j = JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243) * 0.01)
    stats_p = from_numpy_tree(stats_j, "cpu")
    rng = np.random.RandomState(4)
    markers = (rng.randn(C, 1, 81, 3) * 0.3
               + np.linspace(0, 1, T)[None, :, None, None] * [0.5, 0.1, 0]
               + rng.randn(C, T, 81, 3) * 0.05).astype(np.float32)
    joints0 = (np.array([[0, 0, 0.9], [0.1, 0, 0.9], [-0.1, 0.02, 0.9]]
                        + [[0, 0, 1]] * 22)[None]
               + rng.randn(C, 25, 3) * 0.01).astype(np.float32)
    for reduce in (False, True):
        ref = j_s2.smoothness_prior_loss_batched(
            enc_j, jnp.asarray(markers), jnp.asarray(joints0), stats_j,
            reduce_clips=reduce)
        out = t_s2.smoothness_prior_loss_batched(
            enc_t, torch.as_tensor(markers), torch.as_tensor(joints0),
            stats_p, reduce_clips=reduce)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    # the batched form is the per-clip single form
    single = [float(t_s2.smoothness_prior_loss(
        enc_t, torch.as_tensor(markers[c]), torch.as_tensor(joints0[c]),
        stats_p)) for c in range(C)]
    np.testing.assert_allclose(out.numpy(), sum(single), rtol=1e-5)

    ids_t, slices = t_s2.foot_selection(feet, "cpu")
    all_ids = np.concatenate([feet[p] for p in t_s2.FOOT_PARTS])
    np.testing.assert_array_equal(ids_t.numpy(), all_ids)
    fp = (np.ones((C, T, len(all_ids), 3))
          + np.cumsum(rng.randn(C, T, len(all_ids), 3) * 0.01, axis=1)
          ).astype(np.float32)
    lbl = (rng.rand(C, T, 4) > 0.3).astype(np.float32)
    ref = j_s2.contact_friction_loss_batched(jnp.asarray(fp), jnp.asarray(lbl),
                                             slices, reduce_clips=False)
    out = t_s2.contact_friction_loss_batched(torch.as_tensor(fp),
                                             torch.as_tensor(lbl), slices,
                                             reduce_clips=False)
    assert (np.asarray(ref) > 0).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def _quadratics(rng, n):
    a = rng.uniform(0.5, 2.0, (n, 6)).astype(np.float32)
    b = rng.randn(n, 6).astype(np.float32)
    start = b / a + np.where(rng.rand(n, 6) > 0.5, 1.0, -1.0) * 2.0
    return a, b, start.astype(np.float32)


def test_run_adam_per_clip_is_each_clip_alone():
    """Per-clip Adam over C disjoint problems gives, bit for bit, C
    single-problem runs; a poisoned clip freezes alone."""
    a, b, x0 = _quadratics(np.random.RandomState(6), 3)
    A, B = torch.as_tensor(a), torch.as_tensor(b)
    steps, lr = 12, t_adam.piecewise_lr([(0, 0.05), (7, 0.02)], 12)
    poison = {"on": False}

    def per_clip_loss(p):
        per = (0.5 * A * p["x"] ** 2 - B * p["x"]).sum(-1)
        if poison["on"]:
            per = per * torch.tensor([1.0, float("nan"), 1.0])
        return per.sum(), per

    xs, ls = t_adam.run_adam(per_clip_loss, {"x": torch.as_tensor(x0)},
                             steps, lr, per_clip=True)
    assert ls.shape == (3, steps)
    for c in range(3):
        xc, lc = t_adam.run_adam(
            lambda p, c=c: (0.5 * A[c] * p["x"] ** 2 - B[c] * p["x"]).sum(),
            {"x": torch.as_tensor(x0[c])}, steps, lr)
        assert torch.equal(xs["x"][c], xc["x"])
        assert torch.equal(ls[c], lc)
    poison["on"] = True
    xp, lp = t_adam.run_adam(per_clip_loss, {"x": torch.as_tensor(x0)},
                             steps, lr, per_clip=True)
    assert torch.equal(xp["x"][1], torch.as_tensor(x0[1]))
    assert torch.isnan(lp[1]).all()
    assert torch.equal(xp["x"][[0, 2]], xs["x"][[0, 2]])
    with pytest.raises(ValueError):
        t_adam.run_adam(per_clip_loss, {"x": torch.as_tensor(x0)}, 1, lr,
                        per_clip=True, has_aux=True)


def test_fit_clip_temporal_is_the_single_fitter(setup):
    md, port, ids, (target, contact, init72), _ = setup
    tm = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    x1, l1 = t_s2.fit_clip_temporal(tm, *port, *ids, target[1], contact[1],
                                    init72[1], num_steps=S, device="cpu")
    x2, l2 = t_s2.make_temporal_fitter(tm, *port, *ids, num_steps=S,
                                       device="cpu")(target[1], contact[1],
                                                     init72[1])
    assert torch.equal(x1, x2) and torch.equal(l1, l2)


def test_fold_hand_products_by_clip_keep_cpu_bits(setup, monkeypatch):
    """The fold's forward passes `rows=T`, so that on the card each
    clip's hand-PCA products run on its own rows; on the CPU
    `vposer.by_rows` runs one product of all rows whatever `rows` says,
    so the folded fit keeps the bits it had with the hand products over
    all C x T rows (the form before `rows=T`), and with them its
    agreement with lemo_tpu."""
    from lemo_tpu_torch.body_model import smplx

    md, port, ids, data, _ = setup
    seen = []
    real = smplx.by_rows

    def spy(product, x, rows=None):
        seen.append(rows)
        return real(product, x, rows)

    monkeypatch.setattr(smplx, "by_rows", spy)
    x_rows, l_rows = _fitter(md, port, ids, fused=True)(*data)
    assert seen and set(seen) == {T}
    monkeypatch.setattr(smplx, "by_rows",
                        lambda product, x, rows=None: product(x))
    x_all, l_all = _fitter(md, port, ids, fused=True)(*data)
    assert torch.equal(x_rows, x_all) and torch.equal(l_rows, l_all)
