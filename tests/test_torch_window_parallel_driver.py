"""The window-parallel PROX path end to end in both packages on the CPU:
`run_prox_fitting` with `window_parallel: true` on two windows of the
all-terms Stage-3 configuration (interpenetration off; the batched
infill and candidate pre-passes on), with the Jacobi polish here and the
sequential one in tests/test_torch_window_parallel_sequential.py, and
whole chunks (5 iterations at 2 steps a chunk run 6). Under
tests/conftest.py's virtual devices `lemo_tpu` takes its sharded path,
on a 2-device mesh (one window a device; all 8 would pad the 2 windows
to 8 and take minutes); the numbers agree up to reassociation.
Compared: final loss per window within rel 1e-3,
the loss and term histories' lengths, the head hand-off (each window's
frozen head equals the previous window's tail bit for bit), the pkls'
keys, shapes and dtypes; the same for the port's run sharded over two
spawned gloo ranks (one window each, rank 0 the only writer); and the
CLI's window-parallel flags against `lemo_tpu`'s parser."""

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
from lemo_tpu_torch.config import parse_config as t_parse
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting.prox import driver as t_driver

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
CFG = os.path.join(REPO, "cfg_files", "PROXD_temp_S3_all_terms.yaml")
T = 10
POLISH = 5          # 2 Jacobi rounds of 2 iterations, each 2 steps


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


def _args(info, out_dir, mode):
    return ["--config", CFG, "--interpenetration", "false",
            "--recording_dir", info["recording_dir"],
            "--output_folder", out_dir, "--batch_size", str(T),
            "--maxiters", "5", "--steps_per_dispatch", "2",
            "--flip", "false", "--depth_candidates", "64",
            "--sdf_candidates", "64", "--infill_finetune_steps", "2",
            "--window_parallel", "true", "--window_polish_iters",
            str(POLISH), "--window_polish_mode", mode,
            "--window_polish_rounds", "3"]


def run_both(setup, mode):
    """Both packages' window-parallel runs with polish `mode`: (mode,
    recording info, output folders, lemo_tpu's results, the port's)."""
    import lemo_tpu.parallel as j_parallel
    from lemo_tpu.parallel.sharding import make_mesh

    info, j_assets, t_assets = setup
    outs = (tempfile.mkdtemp(), tempfile.mkdtemp())
    j_cfg = j_parse(_args(info, outs[0], mode))
    t_cfg = t_parse(_args(info, outs[1], mode))
    assert dataclasses.asdict(j_cfg) == dict(dataclasses.asdict(t_cfg),
                                             output_folder=outs[0])
    real = j_parallel.make_mesh
    j_parallel.make_mesh = lambda: make_mesh(2)
    try:
        ref = j_driver.run_prox_fitting(j_cfg, j_assets, verbose=False)
    finally:
        j_parallel.make_mesh = real
    res = t_driver.run_prox_fitting(t_cfg, t_assets, verbose=False)
    return mode, info, outs, ref, res


@pytest.fixture(scope="module")
def fits(setup):
    return run_both(setup, "jacobi")


def test_windows_match_jax(fits):
    mode, _, _, ref, res = fits
    assert len(res) == len(ref) == 2
    for w, (r, j) in enumerate(zip(res, ref)):
        assert abs(r.final_loss - j.final_loss) <= 1e-3 * abs(j.final_loss)
        assert r.loss_history.shape == j.loss_history.shape
        assert set(r.term_history) == set(j.term_history)
        for k, v in j.term_history.items():
            assert r.term_history[k].shape == v.shape, k
        for k, v in j.params.items():
            assert r.params[k].shape == v.shape
    # stage 6 steps (whole chunks), then the polish: 2 Jacobi rounds of 2
    # steps for every window (window 0 frozen), or 5 sequential steps (6
    # run, cut to 5) for window 1 only
    if mode == "jacobi":
        want = [(10, 3), (10, 3)]
    else:
        want = [(6, 1), (11, 6)]
    assert [(len(r.loss_history), len(r.term_history["total_loss"]))
            for r in res] == want


def test_head_hand_off_is_bit_equal(fits):
    """Each window's frozen head is the previous window's tail, verbatim,
    in both packages."""
    _, _, _, ref, res = fits
    n = int(T * 0.15)
    off = int(T * 0.7)
    for r0, r1 in (ref, res):
        for k in ("transl", "global_orient", "body_pose", "expression"):
            np.testing.assert_array_equal(r1.params[k][:n],
                                          r0.params[k][off:off + n],
                                          err_msg=k)
        np.testing.assert_array_equal(r1.pose_embedding[:n],
                                      r0.pose_embedding[off:off + n])


def test_timings_and_broad_phase(fits):
    mode, _, _, _, res = fits
    t = t_driver.LAST_PARALLEL_TIMINGS
    assert {"load_s", "prepass_s", "static_build_s", "fit_s", "refresh_s",
            "polish_s", "save_s", "total_s", "polish_mode"} <= set(t)
    assert t["polish_mode"] == mode
    assert ("polish_round_s" in t) == (mode == "jacobi")
    assert 0 < t["fit_s"] <= t["total_s"]
    for r in res:
        assert r.timings == t and r.broad_phase is None


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
    _, info, outs, _, _ = fits
    name = info["recording_name"]
    ref = _tree(os.path.join(outs[0], name, "results"))
    out = _tree(os.path.join(outs[1], name, "results"))
    assert len(ref) == 17
    assert out == ref


@pytest.fixture(scope="module")
def sharded(setup, fits):
    """The port's run of `fits`' configuration on two spawned gloo ranks
    (one window each), rank r writing under its own output folder."""
    from lemo_tpu_torch.parallel.dryrun import job_prox, spawn_ranks

    mode, info, _, _, _ = fits
    outs = [tempfile.mkdtemp(), tempfile.mkdtemp()]
    ranks = spawn_ranks(2, job_prox, {
        "cfg": t_parse(_args(info, outs[0], mode)), "assets": setup[2],
        "output_folders": outs}, device="cpu", threads=2, timeout=600)
    return outs, ranks


def test_sharded_run_matches_jax(fits, sharded):
    """Two ranks, one window each, against lemo_tpu's 2-device run at the
    checks above (final loss rel 1e-3, history lengths, the head hand-off
    bit for bit, the pkls' schema); both ranks return the same results,
    and rank 0 alone writes files."""
    _, info, j_outs, ref, res = fits
    outs, ranks = sharded
    r0, r1 = (r["results"] for r in ranks)
    for got in (r0, r1):
        assert len(got) == 2
        for r, j, p in zip(got, ref, res):
            assert abs(r.final_loss - j.final_loss) <= \
                1e-3 * abs(j.final_loss)
            assert r.loss_history.shape == p.loss_history.shape
            assert {k: v.shape for k, v in r.term_history.items()} == \
                {k: v.shape for k, v in p.term_history.items()}
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a.loss_history, b.loss_history)
        for k, v in a.params.items():
            np.testing.assert_array_equal(v, b.params[k], err_msg=k)
    n, off = int(T * 0.15), int(T * 0.7)
    for k in ("transl", "global_orient", "body_pose", "expression"):
        np.testing.assert_array_equal(r0[1].params[k][:n],
                                      r0[0].params[k][off:off + n],
                                      err_msg=k)
    name = info["recording_name"]
    assert _tree(os.path.join(outs[0], name, "results")) == \
        _tree(os.path.join(j_outs[0], name, "results"))
    assert os.path.exists(os.path.join(outs[0], name, "conf.yaml"))
    assert [f for _, _, fs in os.walk(outs[1]) for f in fs] == []
    assert ranks[0]["timings"]["polish_mode"] == fits[0]
    assert ranks[1]["timings"] == {}


def test_cli_flags_reach_the_driver(monkeypatch):
    """main_slide's window-parallel flags parse as lemo_tpu's parser
    parses them and reach run_prox_fitting."""
    from lemo_tpu_torch.cli import main_slide

    argv = ["--config", CFG, "--recording_dir", "/nowhere",
            "--window_parallel", "true", "--window_polish_iters", "250",
            "--window_polish_mode", "sequential",
            "--window_polish_rounds", "2", "--steps_per_dispatch", "50"]
    seen = {}

    def fake(cfg, assets=None, max_windows=None, verbose=True, device=None):
        seen.update(cfg=cfg, device=device)
        return []

    monkeypatch.setattr(t_driver, "run_prox_fitting", fake)
    assert main_slide.main(argv, device="cpu") == []
    cfg = seen["cfg"]
    assert seen["device"] == "cpu"
    assert (cfg.window_parallel, cfg.window_polish_iters,
            cfg.window_polish_mode, cfg.window_polish_rounds,
            cfg.steps_per_dispatch) == (True, 250, "sequential", 2, 50)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_parse(argv))
