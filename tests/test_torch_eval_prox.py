"""eval_prox in the port vs lemo_tpu: `evaluate_recording` on the
24-frame synthetic recording's PROXD pkls (tests/test_prox_pipeline.py's
TestEvalProx) in both packages, every metric within rel 1e-5, at a chunk
that leaves a short last chunk (16: 16 + 8 frames) and at the CLI's 25
(one short chunk of 24); both CLIs' `main` writing the same JSON; and
the parsers' flags and defaults equal."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.cli import eval_prox as j_eval
from lemo_tpu.data.prox import ProxRecording as JRecording
from lemo_tpu.fitting.prox.camera import PerspectiveCamera as JCamera
from lemo_tpu.testing.synthetic_prox import CX, CY, FX, FY, \
    write_synthetic_prox_recording
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.cli import eval_prox as t_eval
from lemo_tpu_torch.data.prox import ProxRecording as TRecording
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera as TCamera

torch.set_num_threads(2)

KEYS = ("frames", "non_collision", "contact", "accel_m_s2",
        "reproj_err_px", "frames_with_detection")


@pytest.fixture(scope="module")
def recording():
    info = write_synthetic_prox_recording(tempfile.mkdtemp(), num_frames=24,
                                          seed=1)
    return info


def _same_metrics(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in KEYS:
        assert k in got, k
    for k, v in ref.items():
        if isinstance(v, str) or k in ("frames", "frames_with_detection"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("chunk", [16, 25])
def test_evaluate_recording_matches_jax(recording, chunk):
    info = recording
    jrec = JRecording.from_recording_dir(info["recording_dir"])
    trec = TRecording.from_recording_dir(info["recording_dir"])
    folder = os.path.join(jrec.prox_params_dir, "results")
    j_names, j_params = j_eval.load_fitted_frames(folder)
    names, params = t_eval.load_fitted_frames(folder)
    assert names == j_names and len(names) == 24
    for k, v in j_params.items():
        np.testing.assert_array_equal(params[k], v)
    ref = j_eval.evaluate_recording(
        j_names, j_params,
        j_load(info["model_dict"], use_pca=True, num_pca_comps=12), jrec,
        JCamera(FX, FY, (CX, CY)), chunk=chunk, keyp_folder=jrec.keyp_folder)
    got = t_eval.evaluate_recording(
        names, params,
        t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
               device="cpu"), trec,
        TCamera(FX, FY, (CX, CY)), chunk=chunk, keyp_folder=trec.keyp_folder)
    _same_metrics(got, ref)
    assert 0.0 <= got["non_collision"] <= 1.0 and got["reproj_err_px"] < 80


def test_main_writes_the_same_json(recording, tmp_path):
    info = recording
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    np.savez(model_dir / "SMPLX_MALE.npz", **info["model_dict"])
    rec = JRecording.from_recording_dir(info["recording_dir"])
    fitting_dir = os.path.dirname(os.path.join(rec.prox_params_dir, ""))
    outs = []
    for tag, run in (("jax", lambda a: j_eval.main(a)),
                     ("port", lambda a: t_eval.main(a, device="cpu"))):
        out = str(tmp_path / f"{tag}.json")
        run(["--fitting_dir", fitting_dir,
             "--recording_dir", info["recording_dir"],
             "--body_model_path", str(model_dir), "--out", out,
             "--focal_length_x", str(FX), "--focal_length_y", str(FY),
             "--camera_center_x", str(CX), "--camera_center_y", str(CY)])
        with open(out) as fh:
            outs.append(json.load(fh))
    _same_metrics(outs[1], outs[0])
    assert outs[1]["recording"] == info["recording_name"]


def test_parser_flags_and_defaults_match():
    argv = ["--fitting_dir", "/a", "--recording_dir", "/b",
            "--body_model_path", "/c"]
    j_args = vars(j_eval.build_parser().parse_args(argv))
    t_args = vars(t_eval.build_parser().parse_args(argv))
    assert t_args == j_args
    assert t_args["chunk"] == 25 and t_args["contact_thresh"] == 0.02
    j_flags = {a.dest: (a.default, a.type, a.required)
               for a in j_eval.build_parser()._actions}
    t_flags = {a.dest: (a.default, a.type, a.required)
               for a in t_eval.build_parser()._actions}
    assert t_flags == j_flags


def test_main_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_eval.main(["--fitting_dir", "/a", "--recording_dir", "/b",
                     "--body_model_path", "/c"])
