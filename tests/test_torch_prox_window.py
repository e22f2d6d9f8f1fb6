"""The PROX slice end to end in both packages on the CPU: the infill
pre-pass (targets at rel 1e-4), and two windows of the all-terms Stage-3
configuration (interpenetration off) through each package's
`run_prox_fitting` (final loss per window within rel 1e-3, the
per-frame pkls identical in keys, shapes and dtypes)."""

import dataclasses
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.config import parse_config as j_parse
from lemo_tpu.data.stats import GlobalStats as JGlobal
from lemo_tpu.data.stats import Local4ChanStats as JLocal
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.fitting.prox.infill_prepass import run_infill_prepass as j_pre
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.config import parse_config as t_parse
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.fitting.prox.infill_prepass import \
    run_infill_prepass as t_pre
from lemo_tpu_torch.fitting.prox.window import WindowResult, \
    save_window_pkls

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
CFG = os.path.join(REPO, "cfg_files", "PROXD_temp_S3_all_terms.yaml")


@pytest.fixture(scope="module")
def setup():
    info = j_write(tempfile.mkdtemp(), num_frames=17, seed=2,
                   occlusion_frac=0.3)
    rng = np.random.RandomState(1)
    smooth = JGlobal(Xmean=rng.randn(1, 1, 243) * 0.1,
                     Xstd=np.ones(243) * 0.05)
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(0)).items()}
    ae = dict(np.load(os.path.join(ASSETS, "infill_ae.npz")))
    stats = JLocal.load(os.path.join(ASSETS, "infill_stats.npz"))
    vpp = {k: np.asarray(v) for k, v in info["vposer_params"].items()}
    j_assets = j_driver.ProxAssets(
        model=j_load(info["model_dict"], use_pca=True, num_pca_comps=12),
        vposer_params={k: jnp.asarray(v) for k, v in vpp.items()},
        smooth_enc_params={k: jnp.asarray(v) for k, v in enc.items()},
        smooth_stats=smooth,
        infill_ae_params={k: jnp.asarray(v) for k, v in ae.items()},
        infill_stats=stats)
    t_assets = t_driver.ProxAssets(
        model=t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                     device="cpu"),
        vposer_params=from_numpy_tree(vpp, "cpu"),
        smooth_enc_params=from_numpy_tree(enc, "cpu"),
        smooth_stats=from_numpy_tree(smooth, "cpu"),
        infill_ae_params=from_numpy_tree(ae, "cpu"),
        infill_stats=from_numpy_tree(stats, "cpu"))
    return info, j_assets, t_assets


def test_infill_prepass_matches_jax(setup):
    _, j_assets, t_assets = setup
    rng = np.random.RandomState(3)
    T = 16
    t = np.linspace(0, 1, T)[:, None, None]
    joints = (rng.randn(1, 25, 3) * 0.2 + [0.0, 0.0, 0.9]
              + t * [0.6, 0.2, 0.0]).astype(np.float32)
    markers = (rng.randn(1, 67, 3) * [0.2, 0.2, 0.5] + [0.0, 0.0, 0.9]
               + t * [0.6, 0.2, 0.0]
               + rng.randn(T, 67, 3) * 0.005).astype(np.float32)
    mask = (rng.rand(T, 67) > 0.3).astype(np.float32)
    ref = j_pre(j_assets.infill_ae_params, jnp.asarray(markers),
                jnp.asarray(joints), jnp.asarray(mask),
                j_assets.infill_stats, finetune_steps=3)
    out = t_pre(t_assets.infill_ae_params, torch.as_tensor(markers),
                torch.as_tensor(joints), torch.as_tensor(mask),
                t_assets.infill_stats, finetune_steps=3)
    tw = np.asarray(ref.targets_world)
    scale = np.abs(tw).max()
    assert np.abs(out.targets_world.numpy() - tw).max() <= 1e-4 * scale
    np.testing.assert_array_equal(out.contact_lbl.numpy(),
                                  np.asarray(ref.contact_lbl))
    assert out.had_occlusion == ref.had_occlusion


def _cfg_args(info, out_dir):
    return ["--config", CFG, "--interpenetration", "false",
            "--recording_dir", info["recording_dir"],
            "--output_folder", out_dir, "--batch_size", "10",
            "--maxiters", "20", "--flip", "false",
            "--depth_candidates", "64", "--sdf_candidates", "64",
            "--infill_finetune_steps", "3"]


@pytest.fixture(scope="module")
def fits(setup):
    info, j_assets, t_assets = setup
    outs = (tempfile.mkdtemp(), tempfile.mkdtemp())
    j_cfg = j_parse(_cfg_args(info, outs[0]))
    t_cfg = t_parse(_cfg_args(info, outs[1]))
    assert dataclasses.asdict(j_cfg) == dict(dataclasses.asdict(t_cfg),
                                             output_folder=outs[0])
    ref = j_driver.run_prox_fitting(j_cfg, j_assets, verbose=False)
    res = t_driver.run_prox_fitting(t_cfg, t_assets, verbose=False)
    return info, outs, ref, res


def test_two_windows_match_jax(fits):
    _, _, ref, res = fits
    assert len(res) == len(ref) == 2
    for r, j in zip(res, ref):
        assert abs(r.final_loss - j.final_loss) <= 1e-3 * abs(j.final_loss)
        assert r.loss_history.shape == j.loss_history.shape == (20,)
        assert r.loss_history[-1] < r.loss_history[0]
        for k in ("s2m_dist", "m2s_dist", "contact_loss",
                  "motion_infill_loss"):
            assert r.term_history[k][0] > 0, k
            np.testing.assert_allclose(r.term_history[k][0],
                                       j.term_history[k][0], rtol=1e-3)
        for k, v in j.params.items():
            assert r.params[k].shape == v.shape


def test_results_carry_window_timings(fits):
    _, _, _, res = fits
    for r in res:
        assert set(r.timings) == {"load_s", "prepass_s", "static_s", "fit_s",
                                  "save_s", "total_s"}
        assert 0 < r.timings["fit_s"] <= r.timings["total_s"]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".pkl"):
                with open(path, "rb") as fh:
                    rec = pickle.load(fh)
                out[rel] = {k: (np.asarray(v).shape, np.asarray(v).dtype)
                            for k, v in rec.items()}
            else:
                out[rel] = None
    return out


def test_result_pkls_have_the_reference_schema(fits):
    info, outs, _, _ = fits
    name = info["recording_name"]
    ref = _tree(os.path.join(outs[0], name, "results"))
    out = _tree(os.path.join(outs[1], name, "results"))
    assert len(ref) == 17
    assert out == ref
    assert os.path.exists(os.path.join(outs[1], name, "conf.yaml"))


def test_save_window_pkls_camera_params():
    r = WindowResult(params={"transl": np.zeros((2, 3), np.float32)},
                     pose_embedding=np.zeros((2, 32), np.float32),
                     body_pose=np.zeros((2, 63), np.float32),
                     final_loss=0.0, loss_history=np.zeros(1))
    paths = save_window_pkls(r, ["f1", "f2"], tempfile.mkdtemp(),
                             camera_params=t_driver._CAMERA_PKL_PARAMS)
    with open(paths[1], "rb") as fh:
        rec = pickle.load(fh)
    assert rec["camera_rotation"].shape == (1, 3, 3)
    assert rec["transl"].shape == (1, 3)


@pytest.mark.parametrize("opt", ["lbfgs", "lbfgsls", "rmsprop", "sgd"])
def test_unported_optimizers_raise(setup, opt):
    """These optimizers were refused before they were ported; now each is
    served as lemo_tpu serves it (None for L-BFGS, a spec otherwise)."""
    from lemo_tpu.fitting.lbfgs import create_optimizer as j_create
    from lemo_tpu_torch.fitting.adam import RmspropSpec, SgdSpec
    from lemo_tpu_torch.fitting.lbfgs import create_optimizer

    spec = create_optimizer(opt)
    assert (spec is None) == (j_create(opt, 0.01) is None)
    kind = {"rmsprop": RmspropSpec, "sgd": SgdSpec}.get(opt, type(None))
    assert isinstance(spec, kind)


def test_gmm_prior_raises():
    """The GMM prior was refused before it was ported; now, as in
    lemo_tpu, only a missing mixture pickle raises."""
    from lemo_tpu_torch.config.prox_config import ProxConfig

    cfg = ProxConfig(body_prior_type="gmm", prior_folder=tempfile.mkdtemp())
    with pytest.raises(FileNotFoundError, match="gmm_08.pkl"):
        t_driver.build_priors(cfg, "cpu")
