"""Both AMASS CLIs of the port against lemo_tpu's, end to end on the CPU
on one small synthetic dataset (two 1-s clips of one sequence) with the
same weight files, comparing the saved arrays by numbers; and the
parsers' flag sets."""

import os

import jax
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.cli import opt_amass_perframe as j_cli1
from lemo_tpu.cli import opt_amass_temp as j_cli2
from lemo_tpu.data.stats import GlobalStats as JStats
from lemo_tpu.priors.conv_ae import init_smooth_enc, save_state_dict
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.cli import opt_amass_perframe as t_cli1
from lemo_tpu_torch.cli import opt_amass_temp as t_cli2
from lemo_tpu_torch.testing.synthetic import write_amass_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
STEPS = 3
N_CLIPS = 2
T = 29                    # a 1-s clip at 30 fps, less the image's last frame


def _narrow_ae(path):
    """The shipped infill AE with every layer cut to a few channels (the
    same architecture; its convolutions are most of a CPU run's time)."""
    width = {32: 4, 64: 4, 128: 8, 256: 8}
    with np.load(os.path.join(J_ASSETS, "infill_ae.npz")) as z:
        cut = {k: z[k][tuple(slice(width.get(n, n)) for n in z[k].shape)]
               for k in z.files}
    np.savez(path, **cut)


def _flags(parser):
    return {a.dest: (a.type, a.required, tuple(a.choices or ()))
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("pair", [(j_cli1, t_cli1), (j_cli2, t_cli2)])
def test_parser_flags_match(pair):
    ref, out = (_flags(m.build_parser()) for m in pair)
    assert out == ref


def test_parser_defaults_point_at_shipped_assets():
    args = t_cli1.build_parser().parse_args(["--amass_dir", "a",
                                             "--body_model_path", "b"])
    assert os.path.isfile(args.infill_model_path)
    assert os.path.isfile(args.stats_path)
    ref = j_cli2.build_parser().parse_args(["--amass_dir", "a",
                                            "--body_model_path", "b"])
    out = t_cli2.build_parser().parse_args(["--amass_dir", "a",
                                            "--body_model_path", "b"])
    for k, v in vars(ref).items():
        if k not in ("infill_model_path", "stats_path", "smooth_model_path",
                     "smooth_stats_path"):
            assert getattr(out, k) == v, k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The dataset, a full-width model pair (V=10475: the CLIs select the
    SSM2 marker ids unfolded), and the weight files both packages read."""
    root = tmp_path_factory.mktemp("amass_cli")
    write_amass_dataset(str(root / "amass"), "TotalCapture", num_subjects=1,
                        seqs_per_subject=1, num_frames=60 * N_CLIPS, fps=60)
    models = root / "models" / "smplx"
    models.mkdir(parents=True)
    for g in ("male", "female"):
        np.savez(models / f"SMPLX_{g.upper()}.npz", **synthetic_smplx_npz(
            num_verts=10475, num_shape=20, gender=g, seed=5))
    vposer = str(root / "vposer.pkl")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in
                j_vp.init_vposer(jax.random.PRNGKey(0)).items()}, vposer)
    enc = str(root / "enc.npz")
    save_state_dict(init_smooth_enc(jax.random.PRNGKey(1)), enc)
    smooth_stats = str(root / "smooth_stats.npz")
    JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243)).save(smooth_stats)
    ae = str(root / "infill_ae.npz")
    _narrow_ae(ae)
    common = ["--amass_dir", str(root / "amass"), "--body_model_path",
              str(root / "models"), "--clip_seconds", "1", "--step", "1",
              "--num_fit_steps", str(STEPS), "--vposer_ckpt", vposer,
              "--infill_model_path", ae]
    return root, common, enc, smooth_stats


def _out(root, name, i=None, kind="body_params_opt"):
    d = os.path.join(root, name, "TotalCapture")
    if i is None:
        return np.load(os.path.join(d, "gender_list.npy"))
    return np.load(os.path.join(d, f"{kind}_clip_{i}.npy"))


def _check_clip(root, ref, out, i):
    """Contact labels equal; the fitted rows within lemo_tpu's tolerance
    for two forms of one fit (tests/test_fitting_stage2.py:139-140) but
    for at most 1% of them: Adam's first steps move each parameter by
    about +-lr whatever its gradient's size, so a gradient within
    rounding of zero can take either sign (3 of 2,088 entries moved by
    up to 0.26 after 3 Stage-1 steps at lr 0.1)."""
    x_ref, x = _out(root, ref, i), _out(root, out, i)
    assert x.shape == x_ref.shape == (T, 72) and x.dtype == x_ref.dtype
    assert np.isfinite(x).all()
    off = ~np.isclose(x, x_ref, rtol=6e-2, atol=2e-3)
    assert off.mean() <= 0.01, np.argwhere(off)
    c_ref = _out(root, ref, i, "contact_lbl_rec")
    c = _out(root, out, i, "contact_lbl_rec")
    assert c.shape == (T, 4)
    np.testing.assert_array_equal(c, c_ref)


@pytest.fixture(scope="module")
def stage1(corpus):
    root, common, _, _ = corpus
    j_cli1.main(common + [
        "--save_dir", str(root / "s1_ref"),
        "--stats_path", os.path.join(J_ASSETS, "infill_stats.npz")])
    t_cli1.main(common + ["--save_dir", str(root / "s1_out")],
                device="cpu")
    return root


def test_stage1_cli_matches(stage1):
    root = stage1
    np.testing.assert_array_equal(_out(root, "s1_out"), _out(root, "s1_ref"))
    assert list(_out(root, "s1_out")) == [1] * N_CLIPS
    for i in range(N_CLIPS):
        _check_clip(root, "s1_ref", "s1_out", i)


def test_stage2_cli_matches(corpus, stage1):
    """Both packages refine lemo_tpu's Stage-1 results: lemo_tpu with the
    two clips in one batch, the port one clip at a time and in one folded
    batch."""
    root, common, enc, smooth_stats = corpus
    args = common + ["--perframe_res_dir", str(stage1 / "s1_ref"),
                     "--smooth_model_path", enc,
                     "--smooth_stats_path", smooth_stats]
    j_cli2.main(args + [
        "--clip_batch", "2", "--save_dir", str(root / "s2_ref"),
        "--stats_path", os.path.join(J_ASSETS, "infill_stats.npz")])
    for clip_batch in ("1", "2"):
        out = f"s2_out_{clip_batch}"
        t_cli2.main(args + ["--clip_batch", clip_batch,
                            "--save_dir", str(root / out)], device="cpu")
        np.testing.assert_array_equal(_out(root, out), _out(root, "s2_ref"))
        for i in range(N_CLIPS):
            _check_clip(root, "s2_ref", out, i)
            # Stage 2 moved the Stage-1 solution, betas frozen
            x, x1 = _out(root, out, i), _out(root, "s1_ref", i)
            assert not np.allclose(x, x1)
            np.testing.assert_array_equal(x[:, 6:16], x1[:, 6:16])
