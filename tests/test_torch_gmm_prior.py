"""The GMM pose prior in the port vs lemo_tpu: `MaxMixturePrior` against
lemo_tpu's and against the independent min-component NLL of
tests/test_prior_types_stages.py (rtol 1e-5), in the dict and the
sklearn pickle forms; the reference's file naming and the hand mixture's
size through `build_priors`; and the window loss's `pprior_loss` and
`hand_prior_loss` terms against the independent NLL and lemo_tpu's
terms (rtol 2e-4, as test_prior_types_stages.py holds lemo_tpu)."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import make_forward_fn as j_fwd
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.fitting.prox.camera import PerspectiveCamera as JCamera
from lemo_tpu.fitting.prox.losses import ProxStatic as JStatic
from lemo_tpu.fitting.prox.losses import ProxWeights as JWeights
from lemo_tpu.fitting.prox.losses import make_prox_loss as j_loss
from lemo_tpu.priors.body_priors import MaxMixturePrior as JPrior
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn as t_fwd
from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu_torch.config.prox_config import ProxConfig as TConfig
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera as TCamera
from lemo_tpu_torch.fitting.prox.losses import ProxStatic as TStatic
from lemo_tpu_torch.fitting.prox.losses import ProxWeights as TWeights
from lemo_tpu_torch.fitting.prox.losses import make_prox_loss as t_loss
from lemo_tpu_torch.priors.body_priors import MaxMixturePrior as TPrior
from lemo_tpu_torch.priors.body_priors import create_prior
from test_prior_types_stages import _reference_min_nll, _write_gmm_pickle

torch.set_num_threads(2)


class SklearnLikeGmm:
    """The attribute form of sklearn's GaussianMixture pickles."""

    def __init__(self, gmm: dict):
        self.means_ = gmm["means"]
        self.covars_ = gmm["covars"]
        self.weights_ = gmm["weights"]


@pytest.mark.parametrize("form", ["dict", "sklearn"])
@pytest.mark.parametrize("K,D", [(8, 63), (12, 12)])
def test_max_mixture_prior_matches(tmp_path, form, K, D):
    path = str(tmp_path / "gmm.pkl")
    gmm = _write_gmm_pickle(path, K=K, D=D, seed=K)
    if form == "sklearn":
        with open(path, "wb") as fh:
            pickle.dump(SklearnLikeGmm(gmm), fh)
    pose = (np.random.RandomState(D).randn(6, D) * 0.4).astype(np.float32)
    prior = TPrior.from_pickle(path, "cpu")
    ref = JPrior.from_pickle(path)
    for name in ("means", "precisions", "nll_weights"):
        got = getattr(prior, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)))
    out = prior(torch.as_tensor(pose)).numpy()
    assert out.shape == (6,)
    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(pose))),
                               rtol=1e-5)
    np.testing.assert_allclose(out, _reference_min_nll(gmm, pose), rtol=1e-5)


def test_file_naming_and_hand_mixture(tmp_path):
    """gmm_{n:02d}.pkl under prior_folder; the hands read
    gmm_{num_pca_comps:02d}.pkl (main_slide.py:218), so a 12-component
    12-d mixture, and only non-L2 types are built."""
    _write_gmm_pickle(str(tmp_path / "gmm_03.pkl"), K=3, D=6)
    prior = create_prior("gmm", device="cpu", prior_folder=str(tmp_path),
                         num_gaussians=3)
    assert isinstance(prior, TPrior) and tuple(prior.means.shape) == (3, 6)
    _write_gmm_pickle(str(tmp_path / "gmm_08.pkl"), K=8, D=63)
    _write_gmm_pickle(str(tmp_path / "gmm_12.pkl"), K=12, D=12)
    kw = dict(body_prior_type="gmm", left_hand_prior_type="gmm",
              right_hand_prior_type="gmm", prior_folder=str(tmp_path),
              num_gaussians=8, num_pca_comps=12)
    priors = t_driver.build_priors(TConfig(**kw), "cpu")
    ref = j_driver.build_priors(JConfig(**kw))
    assert set(priors) == set(ref) == {"body", "left_hand", "right_hand"}
    for k in priors:
        assert tuple(priors[k].means.shape) == ref[k].means.shape
    assert tuple(priors["left_hand"].means.shape) == (12, 12)
    assert tuple(priors["body"].means.shape) == (8, 63)


def test_gmm_terms_in_the_window_loss(tmp_path):
    """body, hand and both GMM priors with use_vposer=False: pprior_loss
    equals the independent min-component NLL summed over frames times
    body_pose_weight**2 (fitting_temp_slide.py:588-591), hand_prior_loss
    the hands' NLL times hand_prior**2, and both equal lemo_tpu's."""
    gmm = _write_gmm_pickle(str(tmp_path / "gmm_04.pkl"), K=4, D=63)
    hand = _write_gmm_pickle(str(tmp_path / "gmm_12.pkl"), K=12, D=12,
                             seed=1)
    kw = dict(body_prior_type="gmm", left_hand_prior_type="gmm",
              right_hand_prior_type="gmm", num_gaussians=4,
              num_pca_comps=12, prior_folder=str(tmp_path), use_vposer=False)
    md = synthetic_smplx_npz()
    T = 3
    rng = np.random.RandomState(3)
    opt = {k: np.zeros((T, n), np.float32) for k, n in (
        ("transl", 3), ("global_orient", 3), ("jaw_pose", 3),
        ("leye_pose", 3), ("reye_pose", 3), ("expression", 10))}
    opt["body_pose"] = (rng.randn(T, 63) * 0.3).astype(np.float32)
    opt["left_hand_pose"] = (rng.randn(T, 12) * 0.5).astype(np.float32)
    opt["right_hand_pose"] = (rng.randn(T, 12) * 0.5).astype(np.float32)
    mapper = smpl_to_openpose("smplx", True, True, False)
    wkw = dict(body_pose=0.5, hand_prior=0.2, motion_smooth=0.0,
               friction_normal=0.0, friction_tangent=0.0,
               sdf_penetration=0.0)

    jm = j_load(md, use_pca=True, num_pca_comps=12)
    jst = JStatic(gt_joints=jnp.zeros((T, 118, 2)),
                  joints_conf=jnp.ones((T, 118)),
                  joint_weights=jnp.ones(118),
                  camera=JCamera(500.0, 500.0, (320.0, 240.0)),
                  R=jnp.eye(3), t=jnp.zeros(3))
    jf = j_loss(j_fwd(jm), jm.consts, mapper, None, jst, JWeights(**wkw),
                priors=j_driver.build_priors(JConfig(**kw)),
                use_vposer=False)
    _, jterms = jf({k: jnp.asarray(v) for k, v in opt.items()},
                   jnp.zeros((T, 10)), jst)

    tm = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    tst = TStatic(gt_joints=torch.zeros((T, 118, 2)),
                  joints_conf=torch.ones((T, 118)),
                  joint_weights=torch.ones(118),
                  camera=TCamera(500.0, 500.0, (320.0, 240.0)),
                  R=torch.eye(3), t=torch.zeros(3))
    tf = t_loss(t_fwd(tm), tm.consts, mapper, None, tst, TWeights(**wkw),
                priors=t_driver.build_priors(TConfig(**kw), "cpu"),
                use_vposer=False)
    _, tterms = tf({k: torch.as_tensor(v) for k, v in opt.items()},
                   torch.zeros((T, 10)), tst)

    expected = _reference_min_nll(gmm, opt["body_pose"]).sum() * 0.5 ** 2
    hands = (_reference_min_nll(hand, opt["left_hand_pose"]).sum()
             + _reference_min_nll(hand, opt["right_hand_pose"]).sum()) \
        * 0.2 ** 2
    for name, value in (("pprior_loss", expected),
                        ("hand_prior_loss", hands)):
        np.testing.assert_allclose(float(tterms[name]), value, rtol=2e-4)
        np.testing.assert_allclose(float(tterms[name]),
                                   float(jterms[name]), rtol=2e-4)
