"""Fewer windows than ranks in the port's window-parallel PROX driver on
the CPU: `lemo_tpu` pads the window axis to a multiple of its mesh with
copies of window 0 and drops the pads after the fit
(`lemo_tpu/fitting/prox/window.py:423-450`); the port pads it to one
window a rank. One window on two spawned gloo ranks gives the
one-process run's results and pkls bit for bit (rank 0 fits the window
exactly as one process does); two windows on three ranks, with the
Jacobi polish, give those of two ranks without a pad bit for bit (the
two-rank run is the one tests/test_torch_window_parallel_driver.py
holds against `lemo_tpu`; on the CPU it rounds apart from one process,
whose fold decodes all its rows in one product). In both, every rank
returns the recording's windows only, the pad never reaches a pkl, and
rank 0 alone writes."""

import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.config import parse_config as t_parse
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.parallel.dryrun import job_prox, spawn_ranks
from lemo_tpu_torch.priors.conv_ae import init_smooth_enc, \
    load_state_dict_npz

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu_torch", "assets")
CFG = os.path.join(REPO, "cfg_files", "PROXD_temp_S3_all_terms.yaml")
T = 10


def _assets(info):
    rng = np.random.RandomState(1)
    return t_driver.ProxAssets(
        model=t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                     device="cpu"),
        vposer_params=from_numpy_tree(
            {k: np.asarray(v) for k, v in info["vposer_params"].items()},
            "cpu"),
        smooth_enc_params=init_smooth_enc(torch.Generator().manual_seed(0),
                                          device="cpu"),
        smooth_stats=GlobalStats.from_numpy(rng.randn(1, 1, 243) * 0.1,
                                            np.ones(243) * 0.05, "cpu"),
        infill_ae_params=load_state_dict_npz(
            os.path.join(ASSETS, "infill_ae.npz"), "cpu"),
        infill_stats=Local4ChanStats.load(
            os.path.join(ASSETS, "infill_stats.npz"), "cpu"))


def _args(info, out_dir):
    return ["--config", CFG, "--interpenetration", "false",
            "--recording_dir", info["recording_dir"],
            "--output_folder", out_dir, "--batch_size", str(T),
            "--maxiters", "4", "--steps_per_dispatch", "2",
            "--flip", "false", "--depth_candidates", "64",
            "--sdf_candidates", "64", "--infill_finetune_steps", "2",
            "--window_parallel", "true", "--window_polish_iters", "4",
            "--window_polish_mode", "jacobi", "--window_polish_rounds", "2"]


def _pkls(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pkl"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                        pickle.load(fh)
    return out


@pytest.fixture(scope="module", params=[(1, 2), (2, 3)],
                ids=["1-window-2-ranks", "2-windows-3-ranks"])
def runs(request):
    """(windows, ranks, recording info, the reference run's results and
    output folder, each rank's job_prox result and output folder). The
    reference: one process for one window, two ranks (a window each, no
    pad) for two."""
    n_windows, n_ranks = request.param
    info = j_write(tempfile.mkdtemp(), num_frames=T + 7 * (n_windows - 1),
                   seed=2, occlusion_frac=0.3)
    assets = _assets(info)

    def sharded(n):
        outs = [tempfile.mkdtemp() for _ in range(n)]
        ranks = spawn_ranks(n, job_prox, {
            "cfg": t_parse(_args(info, outs[0])), "assets": assets,
            "output_folders": outs}, device="cpu", threads=2, timeout=600)
        return ranks, outs

    if n_windows == 1:
        ref_out = tempfile.mkdtemp()
        ref = t_driver.run_prox_fitting(t_parse(_args(info, ref_out)),
                                        assets, verbose=False)
    else:
        ref_ranks, ref_outs = sharded(n_windows)
        ref, ref_out = ref_ranks[0]["results"], ref_outs[0]
    return n_windows, n_ranks, info, (ref, ref_out), sharded(n_ranks)


def test_ranks_return_the_recordings_windows(runs):
    n_windows, _, _, (ref, _), (ranks, _) = runs
    assert len(ref) == n_windows
    for r in ranks:
        got = r["results"]
        assert len(got) == n_windows
        for a, b in zip(got, ref):
            assert a.loss_history.shape == b.loss_history.shape
            assert {k: v.shape for k, v in a.term_history.items()} == \
                {k: v.shape for k, v in b.term_history.items()}
            for k, v in b.params.items():
                assert a.params[k].shape == v.shape, k
    # every rank holds the same results
    for r in ranks[1:]:
        for a, b in zip(r["results"], ranks[0]["results"]):
            np.testing.assert_array_equal(a.loss_history, b.loss_history)
            for k, v in b.params.items():
                np.testing.assert_array_equal(a.params[k], v, err_msg=k)


def test_padded_run_equals_the_reference(runs):
    """The pads change no bit of the recording's windows: one window on
    two ranks as one process fits it, two windows on three ranks as two
    ranks fit them."""
    _, _, _, (ref, _), (ranks, _) = runs
    for a, b in zip(ranks[0]["results"], ref):
        np.testing.assert_array_equal(a.loss_history, b.loss_history)
        for k, v in b.term_history.items():
            np.testing.assert_array_equal(a.term_history[k], v, err_msg=k)
        for k, v in b.params.items():
            np.testing.assert_array_equal(a.params[k], v, err_msg=k)
        np.testing.assert_array_equal(a.pose_embedding, b.pose_embedding)


def test_the_pad_never_reaches_a_pkl(runs):
    """Rank 0 writes the recording's frames, each pkl bit for bit as the
    reference run writes it (a pad fitted as a later window and written
    would overwrite window 0's frames); the other ranks write nothing."""
    n_windows, _, info, (_, ref_out), (_, outs) = runs
    name = info["recording_name"]
    ref = _pkls(os.path.join(ref_out, name, "results"))
    got = _pkls(os.path.join(outs[0], name, "results"))
    assert len(ref) == T + 7 * (n_windows - 1)
    assert set(got) == set(ref)
    for fn, rec in ref.items():
        assert set(got[fn]) == set(rec)
        for k, v in rec.items():
            np.testing.assert_array_equal(got[fn][k], v,
                                          err_msg=f"{fn} {k}")
    assert os.path.exists(os.path.join(outs[0], name, "conf.yaml"))
    for out in outs[1:]:
        assert [f for _, _, fs in os.walk(out) for f in fs] == []


def test_only_rank_0_sets_the_timings(runs):
    _, _, _, _, (ranks, _) = runs
    assert ranks[0]["timings"]["polish_mode"] == "jacobi"
    assert all(r["timings"] == {} for r in ranks[1:])
