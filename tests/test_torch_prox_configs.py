"""The four shipped PROX configs that only the parser tests read before
(PROXD_temp_S2.yaml, PROXD_temp_S2_multistage.yaml, also with
`window_parallel: true`, PROXD_temp_S2_tpu_fast.yaml and
PROXD_temp_S3_tpu_fast.yaml) through both packages' `run_prox_fitting`
on the CPU, on one synthetic recording (17 frames: two windows of 10 at
stride 7) with the same weights (the port's carried across by
`convert.from_numpy_tree`).

Cut to size as `chip_smoke.py` phase 12 cuts them: STEPS steps a stage
(the configs' 900, or 450 a stage), the tpu_fast pair's
steps_per_dispatch scaled with it (two chunks a window, as 900 in chunks
of 450), the others at the default (one chunk a stage); the multistage
fold's Jacobi polish STEPS iterations, and PROXD_temp_S3_tpu_fast.yaml's
infill finetune 3 steps (60).

The window-parallel case runs on two ranks in both packages: `lemo_tpu`
on a 2-device mesh (one window a device; tests/conftest.py's 8 virtual
devices would pad the 2 windows to 8), the port on two spawned gloo
ranks (one window each). One program over both windows rounds apart
from one over each on the CPU (the port's fold decodes all its rows in
one product there), and each stage's fresh Adam state turns that
rounding into whole steps (below). The port's one-process fold runs too,
for its stage weights and histories.

Compared by numbers, not bits (ROADMAP "Rules of the port"): each
window's final loss within rel LOSS_RTOL (tests/test_torch_prox_window.py's
1e-3), the fitted bodies' marker error against the synthetic ground
truth within MARKER_ATOL (1e-4 m) of lemo_tpu's, the final transl within
TRANSL_ATOL (1e-3 m), the loss histories' and term records' lengths,
every stage's weights as the config lists them (the port's stage
fitters' weights read back), and the pkls' keys, shapes and dtypes. The
transl and marker tolerances are wider than a single op's: at a stage's
first step Adam moves every entry by about lr (0.005) in the sign of its
gradient, so an entry whose gradient is near zero goes whichever way f32
rounding tips it (measured here: transl up to 6.1e-4 m and the marker
error 3.0e-5 m apart after the multistage config's two stages of 4
steps). The fold's Jacobi polish is a third such start, and window 2's
polish starts from window 1's result, so its window 2 is held at
FOLD_TOL (loss rel 5e-3, transl 1e-2 m, marker error 2e-3 m; measured
1.9e-3, 5.0e-3 m and 9.9e-4 m; its window 1 stays within the tolerances
above, at 3.4e-5, 4.6e-5 m and 2.3e-6 m)."""

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
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn
from lemo_tpu_torch.body_model import vposer as t_vp
from lemo_tpu_torch.config import parse_config as t_parse
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data.markers import marker_indices
from lemo_tpu_torch.fitting.prox import driver as t_driver

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
T = 10
FRAMES = 17
STEPS = 4
LOSS_RTOL = 1e-3
TRANSL_ATOL = 1e-3
MARKER_ATOL = 1e-4
FOLD_TOL = (5e-3, 1e-2, 2e-3)   # the fold's window 2: loss, transl, marker
POSE_SCALE = 1.0          # the writer's default

CASES = [
    ("PROXD_temp_S2.yaml", False),
    ("PROXD_temp_S2_multistage.yaml", False),
    ("PROXD_temp_S2_multistage.yaml", True),
    ("PROXD_temp_S2_tpu_fast.yaml", False),
    ("PROXD_temp_S3_tpu_fast.yaml", False),
]


@pytest.fixture(scope="module")
def setup():
    info = j_write(tempfile.mkdtemp(), num_frames=FRAMES, seed=2,
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


def _args(info, config, out_dir, window_parallel):
    path = os.path.join(REPO, "cfg_files", config)
    args = ["--config", path, "--recording_dir", info["recording_dir"],
            "--output_folder", out_dir, "--batch_size", str(T),
            "--maxiters", str(STEPS), "--flip", "false",
            "--infill_finetune_steps", "3"]
    shipped = t_parse(["--config", path])
    if shipped.steps_per_dispatch != t_driver.ProxConfig.steps_per_dispatch:
        args += ["--steps_per_dispatch", str(
            STEPS * shipped.steps_per_dispatch // shipped.maxiters)]
    if window_parallel:
        args += ["--window_parallel", "true",
                 "--window_polish_iters", str(STEPS)]
    return args


def _gt_markers(info, model):
    """The ground-truth bodies' 67 markers [FRAMES, 67, 3] (camera
    coordinates), rebuilt as the writer posed them."""
    vpp = from_numpy_tree({k: np.asarray(v) for k, v in
                           info["vposer_params"].items()}, "cpu")
    params = model.zero_params(FRAMES)
    with torch.no_grad():
        params["body_pose"] = t_vp.decode(vpp, torch.as_tensor(
            info["gt_pose_embedding"]), "aa") * POSE_SCALE
        params["transl"] = torch.as_tensor(info["gt_transl"],
                                           dtype=torch.float32)
        params["global_orient"] = torch.tensor([[np.pi, 0.0, 0.0]]).expand(
            FRAMES, 3)
    return _markers(model, params)


def _markers(model, params):
    ids = torch.as_tensor(marker_indices(False, num_verts=model.num_verts))
    with torch.no_grad():
        out = make_forward_fn(model)(params, model.consts)
    return out["vertices"][:, ids].numpy()


def _marker_err(model, result, gt):
    """Mean |marker - ground truth| (m) of a window's fitted bodies."""
    params = {k: torch.as_tensor(np.asarray(v)) for k, v in
              result.params.items()}
    return float(np.abs(_markers(model, params) - gt).mean())


class _StageWeights:
    """Record the weights each stage fitter of the port's driver is
    built with (the sequential and the window-parallel factory)."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("make_window_fitter", "make_batched_window_fitter"):
            real = getattr(t_driver, name)
            monkeypatch.setattr(t_driver, name, self._spy(real))

    def _spy(self, real):
        def build(*args, **kw):
            w = args[4]
            self.seen.append((w.sdf_penetration, w.friction_normal,
                              w.friction_tangent))
            return real(*args, **kw)
        return build


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pkl"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    rec = pickle.load(fh)
                out[os.path.relpath(os.path.join(dirpath, f), root)] = {
                    k: (np.asarray(v).shape, np.asarray(v).dtype)
                    for k, v in rec.items()}
    return out


@pytest.mark.parametrize("config,window_parallel", CASES,
                         ids=[c[:-5] + ("-wp" if wp else "")
                              for c, wp in CASES])
def test_config_matches_lemo_tpu(setup, monkeypatch, config,
                                 window_parallel):
    import lemo_tpu.parallel as j_parallel
    from lemo_tpu.parallel.sharding import make_mesh
    from lemo_tpu_torch.parallel.dryrun import job_prox, spawn_ranks

    info, j_assets, t_assets = setup
    outs = (tempfile.mkdtemp(), tempfile.mkdtemp())
    j_cfg = j_parse(_args(info, config, outs[0], window_parallel))
    t_cfg = t_parse(_args(info, config, outs[1], window_parallel))
    assert dataclasses.asdict(j_cfg) == dict(dataclasses.asdict(t_cfg),
                                             output_folder=outs[0])
    monkeypatch.setattr(j_parallel, "make_mesh", lambda: make_mesh(2))
    ref = j_driver.run_prox_fitting(j_cfg, j_assets, verbose=False)
    stages = _StageWeights(monkeypatch)
    one = t_driver.run_prox_fitting(t_cfg, t_assets, verbose=False)
    res = one
    if window_parallel:
        ranks = [tempfile.mkdtemp(), tempfile.mkdtemp()]
        res = spawn_ranks(2, job_prox, {
            "cfg": t_parse(_args(info, config, ranks[0], True)),
            "assets": t_assets, "output_folders": ranks},
            device="cpu", threads=2, timeout=600)[0]["results"]

    # the stage fitters' weights are the config's entries, stage by stage
    want = [tuple(t_cfg.stage_weights(s)[k] for k in (
        "sdf_penetration", "friction_normal", "friction_tangent"))
        for s in range(t_cfg.n_stages)]
    assert stages.seen[:t_cfg.n_stages] == want
    if config == "PROXD_temp_S2_multistage.yaml":
        assert want == [(0.001, 5.0, 10.0), (0.003, 10.0, 20.0)]

    gt = _gt_markers(info, t_assets.model)
    assert len(res) == len(one) == len(ref) == 2
    for w, (r, o, j) in enumerate(zip(res, one, ref)):
        for x in (r, o):
            assert x.loss_history.shape == j.loss_history.shape
            assert np.isfinite(x.loss_history).all()
            assert {k: v.shape for k, v in x.term_history.items()} == \
                {k: v.shape for k, v in j.term_history.items()}
        loss_rtol, transl_atol, marker_atol = \
            FOLD_TOL if window_parallel and w == 1 else \
            (LOSS_RTOL, TRANSL_ATOL, MARKER_ATOL)
        assert abs(r.final_loss - j.final_loss) <= \
            loss_rtol * abs(j.final_loss), w
        np.testing.assert_allclose(r.params["transl"], j.params["transl"],
                                   rtol=0, atol=transl_atol)
        sl = slice(7 * w, 7 * w + T)
        err = _marker_err(t_assets.model, r, gt[sl])
        err_ref = _marker_err(t_assets.model, j, gt[sl])
        assert abs(err - err_ref) <= marker_atol, (w, err, err_ref)
    if not window_parallel:
        # every stage's steps, the multistage config's twice
        assert one[0].loss_history.shape == (t_cfg.n_stages * STEPS,)
    name = info["recording_name"]
    got = _tree(os.path.join(outs[1], name, "results"))
    assert len(got) == FRAMES
    assert got == _tree(os.path.join(outs[0], name, "results"))
