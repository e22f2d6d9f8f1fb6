"""The PROX window fitters' optimizer surface in the port vs lemo_tpu
(the port's counterparts of tests/test_optimizer_surface.py), on the
small synthetic SMPL-X and a 20-frame recording (batch 16: two windows,
the second with its 2-frame overlap head frozen):

- an `lbfgsls` fit of both windows through each package's
  `run_prox_fitting`, 4 steps at 2 a chunk (the state carried across a
  chunk), held to chip_smoke.py phase 9b's rules: the first step's loss
  within rel 1e-5, the same line-search trial count k at every step,
  the final loss within rel 1e-3;
- `rmsprop` and `sgd` fits, sequential and window-parallel, the final
  optimized parameters (the VPoser latent among them) within atol 1e-5
  of lemo_tpu's (lemo_tpu's fold on a 2-device mesh, one window a
  device, as tests/test_torch_window_parallel_driver.py runs it). The
  saved body_pose is the latent's decode, not a parameter: the two
  packages' decodes of one latent differ by ~8e-6 after one step of
  any optimizer, Adam included, and the decode carries that on;
- the fold refusing L-BFGS with lemo_tpu's message, and unknown names
  refused by both fitters;
- SGD and Adam giving different results.
"""

import contextlib
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.config.prox_config import ProxConfig as TConfig
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting.prox import driver as t_driver
from test_torch_lbfgs import jax_trial_counts

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    info = j_write(tempfile.mkdtemp(), num_frames=20, seed=21)
    vpp = {k: np.asarray(v) for k, v in info["vposer_params"].items()}
    j_assets = j_driver.ProxAssets(
        model=j_load(info["model_dict"], use_pca=True, num_pca_comps=12),
        vposer_params={k: jnp.asarray(v) for k, v in vpp.items()})
    t_assets = t_driver.ProxAssets(
        model=t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                     device="cpu"),
        vposer_params=from_numpy_tree(vpp, "cpu"))
    return info, j_assets, t_assets


def _kw(info, **kw):
    base = dict(
        recording_dir=info["recording_dir"], batch_size=16, maxiters=8,
        lr=0.01, flip=False, s2m=False, m2s=False, read_depth=False,
        read_mask=False, init_mode="none", sdf_penetration=False,
        use_friction=False, use_motion_smooth_prior=False,
        interpenetration=False, contact=False,
        use_motion_infill_prior=False)
    base.update(kw)
    return base


@contextlib.contextmanager
def _two_device_mesh():
    import lemo_tpu.parallel as j_parallel
    from lemo_tpu.parallel.sharding import make_mesh

    real = j_parallel.make_mesh
    j_parallel.make_mesh = lambda: make_mesh(2)
    try:
        yield
    finally:
        j_parallel.make_mesh = real


def run_port(setup, **kw):
    info, _, t_assets = setup
    cfg = TConfig(**_kw(info, output_folder=tempfile.mkdtemp(), **kw))
    return t_driver.run_prox_fitting(cfg, t_assets, verbose=False)


def run_jax(setup, **kw):
    info, j_assets, _ = setup
    cfg = JConfig(**_kw(info, output_folder=tempfile.mkdtemp(), **kw))
    with _two_device_mesh():
        return j_driver.run_prox_fitting(cfg, j_assets, verbose=False)


def test_lbfgsls_windows_match_jax(setup, monkeypatch):
    kw = dict(optim_type="lbfgsls", maxiters=4, steps_per_dispatch=2)
    j_trials: list = []
    with jax_trial_counts(j_trials):
        ref = run_jax(setup, **kw)
    t_trials: list = []
    real = t_driver.fit_window

    def recorded(*args, **fkw):
        out = real(*args, **fkw)
        t_trials.extend(fkw["fitter"].last_state.trials)
        return out

    monkeypatch.setattr(t_driver, "fit_window", recorded)
    res = run_port(setup, **kw)
    assert len(res) == len(ref) == 2
    assert len(t_trials) == 8 and t_trials == j_trials
    for r, j in zip(res, ref):
        assert r.loss_history.shape == j.loss_history.shape == (4,)
        rel0 = abs(r.loss_history[0] - j.loss_history[0]) / abs(
            j.loss_history[0])
        assert rel0 < 1e-5
        assert abs(r.final_loss - j.final_loss) < 1e-3 * abs(j.final_loss)
        assert np.isfinite(r.loss_history).all()
        assert r.loss_history[-1] < r.loss_history[0]
        assert set(r.term_history) == set(j.term_history)
    # windows (0, 16) and (4, 20): the second window's 2 frozen head
    # frames are the first window's frames 4 and 5, read from its pkls
    for k, v in res[1].params.items():
        np.testing.assert_array_equal(v[:2], res[0].params[k][4:6])


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "fold"])
@pytest.mark.parametrize("optim_type", ["rmsprop", "sgd"])
def test_gradient_family_matches_jax(setup, optim_type, parallel):
    kw = dict(optim_type=optim_type, lr=1e-3)
    if parallel:
        kw.update(window_parallel=True, window_polish_iters=0)
    ref = run_jax(setup, **kw)
    res = run_port(setup, **kw)
    assert len(res) == len(ref) == 2
    for r, j in zip(res, ref):
        assert np.isfinite(r.loss_history).all()
        assert r.loss_history[-1] < r.loss_history[0]
        np.testing.assert_allclose(r.pose_embedding, j.pose_embedding,
                                   atol=1e-5)
        for k, v in j.params.items():
            if k != "body_pose":
                np.testing.assert_allclose(r.params[k], v, atol=1e-5,
                                           err_msg=k)


def test_fold_refuses_lbfgs(setup):
    for run in (run_port, run_jax):
        with pytest.raises(ValueError, match="window_parallel"):
            run(setup, optim_type="lbfgsls", window_parallel=True,
                window_polish_iters=0)


def test_unknown_optimizer_raises(setup):
    for parallel in (False, True):
        with pytest.raises(ValueError, match="not supported"):
            run_port(setup, optim_type="newton", window_parallel=parallel)


def test_sgd_and_adam_differ(setup):
    r_adam = run_port(setup, optim_type="adam")[0]
    r_sgd = run_port(setup, optim_type="sgd")[0]
    assert not np.allclose(r_adam.params["transl"], r_sgd.params["transl"])
