"""The self-intersection candidate pre-pass of the port's PROX driver
(auto-K and the stage-boundary refresh, the cases of
tests/test_coll_autok.py against `lemo_tpu_torch`), and both packages'
`run_prox_fitting` with interpenetration on and a part-segmentation pkl.

Bodies are the small smooth-surface synthetic model (536 vertices, 544
faces) posed at pose_scale 0.9, so faces on different tubes collide.

Tolerances:
- the subset energy against the full sweep of the same package: rel
  1e-5, as in tests/test_coll_autok.py (the same gates on the same
  geometry; only the summation order differs);
- between the packages, the coll term's first value: rel 3e-4, the
  bound of tests/test_intersection_pallas.py for the same energy computed
  from geometry rounded differently (a few razor-edge gates may flip;
  measured 6e-8);
- between the packages, the final loss after 4 Adam steps: rel 1e-3, as
  tests/test_torch_prox_window.py holds the Stage-3 fit; the coll term
  is weighted 1.0 here, so a gate flip moves the loss through it and
  Adam's normalized steps carry that on (measured 2.5e-5).
"""

import dataclasses
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.testing.synthetic import synthetic_smplx_npz as j_npz
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model
from lemo_tpu_torch.config.prox_config import ProxConfig
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset
from lemo_tpu_torch.fitting.prox import driver
from lemo_tpu_torch.fitting.prox.driver import ProxAssets, \
    _coll_candidate_ids, _coll_pick_K, _warm_start_vertices, \
    run_prox_fitting
from lemo_tpu_torch.ops.intersection import batched_self_intersection, \
    intersection_candidate_scores_batched
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz, \
    write_part_segm_pkl
from lemo_tpu_torch.testing.synthetic_prox import \
    write_synthetic_prox_recording

torch.set_num_threads(2)

_CFG = dict(batch_size=6, maxiters=4, lr=0.005, flip=False, s2m=False,
            m2s=False, read_depth=False, read_mask=False, init_mode="none",
            sdf_penetration=False, use_friction=False,
            use_motion_smooth_prior=False, interpenetration=True,
            coll_loss_weights=[1.0], contact=False,
            use_motion_infill_prior=False, use_vposer=False)


def _setup(coll_candidates=32, auto=True, seed=23, pose_scale=0.9):
    base = tempfile.mkdtemp()
    md = synthetic_smplx_npz(smooth_surface=True)
    info = write_synthetic_prox_recording(
        base, num_frames=8, model_dict=md, seed=seed, write_depth=False,
        pose_scale=pose_scale)
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cpu")
    cfg = ProxConfig(recording_dir=info["recording_dir"],
                     output_folder=tempfile.mkdtemp(),
                     coll_candidates=coll_candidates,
                     coll_candidates_auto=auto, **_CFG)
    assets = ProxAssets(model=model, vposer_params=info["vposer_params"])
    return cfg, assets, info, md


def _warm(cfg):
    rec = ProxRecording.from_recording_dir(cfg.recording_dir)
    ds = ProxWindowDataset(rec, output_params_dir=tempfile.mkdtemp(),
                           batch_size=cfg.batch_size, flip=False,
                           read_depth=False, read_mask=False)
    return {k: torch.as_tensor(v)
            for k, v in ds.load_window(0)["warm_start"].items()}


class TestCollAutoK:
    def test_pick_K_growth_rule(self):
        cfg = ProxConfig(coll_candidates=64, coll_candidates_auto=True)
        assert _coll_pick_K(cfg, n_active=40, n_within=40, F=30000) == 64
        assert _coll_pick_K(cfg, n_active=100, n_within=100, F=30000) == 1024
        assert _coll_pick_K(cfg, n_active=1500, n_within=1500,
                            F=30000) == 2048
        assert _coll_pick_K(cfg, n_active=29999, n_within=29999,
                            F=30000) == 30000
        off = dataclasses.replace(cfg, coll_candidates_auto=False)
        with pytest.warns(UserWarning, match="FIRING"):
            assert _coll_pick_K(off, n_active=100, n_within=100,
                                F=30000) == 64

    def test_auto_K_exact_at_refresh(self):
        """With a deliberately tiny configured K, auto mode grows the
        candidate set to cover every firing face: the subset energy then
        equals the full sweep at the warm start."""
        cfg, assets, _, md = _setup(coll_candidates=8, auto=True)
        warm = _warm(cfg)
        verts = _warm_start_vertices(cfg, assets, warm)
        faces = torch.as_tensor(md["f"])
        _, counts = intersection_candidate_scores_batched(verts[:1], faces)
        n_active = int(counts[0, 0])
        assert n_active > 8, "test needs a pose with firing pairs"
        ids, stats = _coll_candidate_ids(cfg, assets, warm)
        assert ids.shape[1] == stats["K"] >= n_active
        assert stats["n_active"] >= n_active and stats["scores_s"] > 0
        full = batched_self_intersection(verts[:1], faces)
        sub = batched_self_intersection(verts[:1], faces,
                                        candidate_ids=torch.as_tensor(ids[:1]))
        assert float(full[0]) > 0
        np.testing.assert_allclose(sub.numpy(), full.numpy(), rtol=1e-5)

    def test_no_auto_warns_and_keeps_K(self):
        cfg, assets, _, _ = _setup(coll_candidates=8, auto=False)
        warm = _warm(cfg)
        with pytest.warns(UserWarning, match="coll_candidates"):
            ids, _ = _coll_candidate_ids(cfg, assets, warm)
        assert ids.shape[1] == 8
        assert (np.diff(ids, axis=1) > 0).all()     # face-id order


class TestStageRefresh:
    def test_two_stage_candidates_match_exact(self):
        """A 2-stage fit with stage-refreshed coll candidates tracks the
        candidates-off (full-sweep) fit: the stage-1 candidate set is
        rebuilt from the stage-0 solution, so the subset energy is exact
        at the second stage's warm start too."""
        cfg, assets, _, _ = _setup(coll_candidates=8, auto=True)
        two_stage = dict(coll_loss_weights=[1.0, 1.0],
                         data_weights=[1.0, 1.0], maxiters=4)
        cfg_on = dataclasses.replace(
            cfg, output_folder=tempfile.mkdtemp(), **two_stage)
        cfg_off = dataclasses.replace(
            cfg, output_folder=tempfile.mkdtemp(), coll_candidates=0,
            **two_stage)
        res_on = run_prox_fitting(cfg_on, assets, max_windows=1,
                                  verbose=False)[0]
        res_off = run_prox_fitting(cfg_off, assets, max_windows=1,
                                   verbose=False)[0]
        assert res_on.term_history["self_penetration_loss"].shape[0] == 8
        assert res_on.broad_phase["K"] >= res_on.broad_phase["n_active"]
        assert res_off.broad_phase is None
        np.testing.assert_allclose(
            res_on.term_history["self_penetration_loss"],
            res_off.term_history["self_penetration_loss"],
            rtol=5e-3, atol=1e-7)
        np.testing.assert_allclose(res_on.params["transl"],
                                   res_off.params["transl"], atol=5e-5)

    def test_refresh_rebuilds_from_stage_warm(self, monkeypatch):
        """The stage-1 candidate pre-pass sees the stage-0 solution, not
        the original window warm start."""
        cfg, assets, _, _ = _setup(coll_candidates=8, auto=True)
        cfg = dataclasses.replace(
            cfg, output_folder=tempfile.mkdtemp(),
            coll_loss_weights=[1.0, 1.0], data_weights=[1.0, 1.0],
            maxiters=4)
        seen = []
        orig = driver._coll_candidate_ids

        def spy(cfg_, assets_, warm_, *args):
            seen.append(warm_["transl"].numpy().copy())
            return orig(cfg_, assets_, warm_, *args)

        monkeypatch.setattr(driver, "_coll_candidate_ids", spy)
        run_prox_fitting(cfg, assets, max_windows=1, verbose=False)
        assert len(seen) == 2
        assert np.abs(seen[1] - seen[0]).max() > 0


@pytest.mark.parametrize("coll_candidates", [0, 8])
def test_run_prox_fitting_matches_jax(coll_candidates):
    """Both packages fit one window of the same recording with
    interpenetration on, the six shipped ign_part_pairs and a 27-part
    segmentation pkl, over all faces and over auto-grown candidates."""
    md = j_npz(smooth_surface=True)
    info = j_write(tempfile.mkdtemp(), num_frames=8, model_dict=md, seed=23,
                   write_depth=False, pose_scale=0.9)
    pkl = os.path.join(tempfile.mkdtemp(), "parts_segm.pkl")
    write_part_segm_pkl(pkl, md["f"], num_parts=27)
    kw = dict(_CFG, recording_dir=info["recording_dir"], part_segm_fn=pkl,
              ign_part_pairs=["9,16", "9,17", "6,16", "6,17", "1,2",
                              "12,22"],
              coll_candidates=coll_candidates, coll_candidates_auto=True)
    j_cfg = JConfig(output_folder=tempfile.mkdtemp(), **kw)
    t_cfg = ProxConfig(output_folder=tempfile.mkdtemp(), **kw)
    j_model = j_load(md, use_pca=True, num_pca_comps=12)
    segm, tab = j_driver.load_part_segm(pkl, j_model.faces,
                                        kw["ign_part_pairs"])
    j_assets = j_driver.ProxAssets(
        model=j_model, faces_segm=segm, ign_table=tab,
        vposer_params={k: jnp.asarray(v)
                       for k, v in info["vposer_params"].items()})
    t_model = load_model(md, use_pca=True, num_pca_comps=12, device="cpu")
    t_segm, t_tab = driver.part_filter(t_cfg, t_model.faces)
    np.testing.assert_array_equal(t_segm, segm)
    np.testing.assert_array_equal(t_tab, tab)
    t_assets = ProxAssets(
        model=t_model, faces_segm=t_segm, ign_table=t_tab,
        vposer_params=from_numpy_tree(
            {k: np.asarray(v) for k, v in info["vposer_params"].items()},
            "cpu"))
    ref = j_driver.run_prox_fitting(j_cfg, j_assets, max_windows=1,
                                    verbose=False)[0]
    out = run_prox_fitting(t_cfg, t_assets, max_windows=1, verbose=False)[0]
    e_ref = ref.term_history["self_penetration_loss"]
    e_out = out.term_history["self_penetration_loss"]
    assert e_ref[0] > 0 and e_out.shape == e_ref.shape == (4,)
    assert abs(e_out[0] - e_ref[0]) <= 3e-4 * e_ref[0]
    assert abs(out.final_loss - ref.final_loss) <= 1e-3 * abs(ref.final_loss)
    assert out.loss_history[-1] < out.loss_history[0]
