"""The port's trainer CLIs, test_smooth_prior and eval_amass against
lemo_tpu's, end to end on the CPU through `main(argv, device="cpu")`, on
one small synthetic corpus (1-s clips, a V=10475 model pair with 20
shape directions), comparing their output files and keys, the logged
losses and the metrics by numbers; and the parsers' flag sets.

The trainers start from lemo_tpu's initial parameters carried across
(its draws are jax.random's), and the infill trainer's random masks are
lemo_tpu's draws fed through `random_mask_draws`."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.cli import eval_amass as j_eval
from lemo_tpu.cli import test_smooth_prior as j_test
from lemo_tpu.cli import train_infill_prior as j_infill
from lemo_tpu.cli import train_smooth_prior as j_smooth
from lemo_tpu.priors.conv_ae import init_infill_ae as j_init_infill_ae
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu.train import smooth as j_ts
from lemo_tpu_torch.cli import eval_amass as t_eval
from lemo_tpu_torch.cli import test_smooth_prior as t_test
from lemo_tpu_torch.cli import train_infill_prior as t_infill
from lemo_tpu_torch.cli import train_smooth_prior as t_smooth
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.testing.synthetic import write_amass_dataset
from lemo_tpu_torch.train import infill as t_ti
from lemo_tpu_torch.train import smooth as t_ts

torch.set_num_threads(2)
STEPS = 3
PAIRS = [(j_smooth, t_smooth), (j_infill, t_infill), (j_test, t_test),
         (j_eval, t_eval)]


def _flags(parser):
    """Each flag's dest, default, requiredness, choices and how its type
    reads a few strings (the boolean flags are lambdas in lemo_tpu)."""
    def reads(t):
        out = []
        for x in ("true", "0", "2", "1.5", "abc"):
            try:
                out.append(t(x))
            except ValueError:
                out.append("ValueError")
        return tuple(out)

    return {a.dest: (a.default, a.required, tuple(a.choices or ()),
                     reads(a.type) if a.type else None)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0].__name__)
def test_parser_flags_match(pair):
    ref, out = (_flags(m.build_parser()) for m in pair)
    assert out == ref


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A CMU train split (two sequences of 2 s: four 1-s clips), a
    TotalCapture test split (two 1-s clips, one a gender), the model pair
    and a VPoser checkpoint."""
    root = tmp_path_factory.mktemp("train_cli")
    write_amass_dataset(str(root / "amass"), "CMU", num_subjects=1,
                        seqs_per_subject=2, num_frames=120, fps=60)
    write_amass_dataset(str(root / "amass"), "TotalCapture", num_subjects=1,
                        seqs_per_subject=2, num_frames=60, fps=60, seed=7)
    models = root / "models" / "smplx"
    models.mkdir(parents=True)
    for g in ("male", "female"):
        np.savez(models / f"SMPLX_{g.upper()}.npz", **synthetic_smplx_npz(
            num_verts=10475, num_shape=20, gender=g, seed=5))
    vposer = str(root / "vposer.pkl")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in
                j_vp.init_vposer(jax.random.PRNGKey(0)).items()}, vposer)
    common = ["--amass_dir", str(root / "amass"), "--body_model_path",
              str(root / "models"), "--clip_seconds", "1"]
    return root, common, vposer


def _run_dir(save_dir):
    runs = glob.glob(os.path.join(save_dir, "*"))
    assert len(runs) == 1, runs
    return runs[0]


def _check_run_dirs(j_dir, t_dir, ckpts):
    for d in (j_dir, t_dir):
        assert len(glob.glob(os.path.join(d, "run_*.log"))) == 1
    with open(os.path.join(j_dir, "params.json")) as f:
        ref = json.load(f)
    with open(os.path.join(t_dir, "params.json")) as f:
        out = json.load(f)
    assert {k: v for k, v in out.items() if k != "save_dir"} == \
        {k: v for k, v in ref.items() if k != "save_dir"}
    for name in ckpts:
        with np.load(os.path.join(j_dir, name)) as zr, \
                np.load(os.path.join(t_dir, name)) as zo:
            assert set(zo.files) == set(zr.files)
            for k in zr.files:
                assert zo[k].shape == zr[k].shape and zo[k].dtype == np.float32
                assert np.isfinite(zo[k]).all()


def _check_history(hist, ref, keys):
    assert [h["step"] for h in hist] == [h["step"] for h in ref] == \
        list(range(1, STEPS + 1))
    for h, r in zip(hist, ref):
        assert set(h) == set(r)
        for k in keys:
            np.testing.assert_allclose(h[k], r[k], rtol=1e-4, err_msg=k)


def _stats(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def smooth_runs(corpus, tmp_path_factory):
    """Both smoothness-prior CLIs, each from its own working directory
    (the statistics path is relative to it), the port from lemo_tpu's
    initial parameters."""
    _, common, _ = corpus
    argv = common + ["--batch_size", "2", "--num_steps", str(STEPS),
                     "--log_step", "1", "--save_dir", "runs"]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_ts, "init_params", lambda gen, cfg, device: (
            from_numpy_tree(j_ts.init_params(jax.random.PRNGKey(0), cfg),
                            device)))
        for name, main, kw in (("jax", j_smooth.main, {}),
                               ("port", t_smooth.main, {"device": "cpu"})):
            cwd = tmp_path_factory.mktemp(f"smooth_{name}")
            mp.chdir(cwd)
            out[name] = (str(cwd), main(argv, **kw)[1])
    finally:
        mp.undo()
    return out


def test_train_smooth_prior_cli_matches_jax(smooth_runs):
    (j_cwd, j_hist), (t_cwd, t_hist) = smooth_runs["jax"], smooth_runs["port"]
    _check_run_dirs(_run_dir(os.path.join(j_cwd, "runs")),
                    _run_dir(os.path.join(t_cwd, "runs")),
                    ["Enc_last_model.npz", "Dec_last_model.npz"])
    stats = "preprocess_stats/preprocess_stats_smooth_withHand_global_markers.npz"
    ref, out = _stats(os.path.join(j_cwd, stats)), _stats(
        os.path.join(t_cwd, stats))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6)
    # the z-smoothness terms are cancellation in z[t+1] - z[t] (~1e-7
    # here); the totals hold them
    _check_history(t_hist, j_hist, ["total", "loss_rec_v",
                                    "test_loss_rec_v"])


def test_test_smooth_prior_cli_matches_jax(corpus, smooth_runs):
    _, common, _ = corpus
    j_cwd = smooth_runs["jax"][0]
    run = _run_dir(os.path.join(j_cwd, "runs"))
    argv = common + [
        "--enc_path", os.path.join(run, "Enc_last_model.npz"),
        "--dec_path", os.path.join(run, "Dec_last_model.npz"),
        "--stats_path", os.path.join(
            j_cwd, "preprocess_stats",
            "preprocess_stats_smooth_withHand_global_markers.npz"),
        "--num_clips", "2"]
    ref = j_test.main(argv)
    out = t_test.main(argv, device="cpu")
    assert len(out) == len(ref) == 2
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def _jax_mask_draws(seed):
    """lemo_tpu's random-mask draws in its order: a key split a step,
    then uniform scores and counts from the step key's two halves."""
    key = [jax.random.PRNGKey(seed + 1)]

    def draws(gen, batch_size, device):
        key[0], sub = jax.random.split(key[0])
        k1, k2 = jax.random.split(sub)
        scores = jax.random.uniform(k1, (batch_size, 67))
        n = jax.random.randint(k2, (batch_size, 1), 1, 7)
        return (torch.as_tensor(np.asarray(scores), device=device),
                torch.as_tensor(np.asarray(n), device=device))
    return draws


def test_train_infill_prior_cli_matches_jax(corpus, tmp_path, monkeypatch):
    _, common, _ = corpus
    argv = common + ["--batch_size", "2", "--num_steps", str(STEPS),
                     "--log_step", "1", "--save_dir", "runs"]
    monkeypatch.setattr(t_ti, "init_infill_ae", lambda gen, **kw: (
        from_numpy_tree(j_init_infill_ae(jax.random.PRNGKey(0)), "cpu")))
    monkeypatch.setattr(t_ti, "random_mask_draws", _jax_mask_draws(0))
    hist = {}
    for name, main, kw in (("jax", j_infill.main, {}),
                           ("port", t_infill.main, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        hist[name] = main(argv, **kw)[1]
    _check_run_dirs(_run_dir(str(tmp_path / "jax" / "runs")),
                    _run_dir(str(tmp_path / "port" / "runs")),
                    ["AE_last_model.npz"])
    stats = "preprocess_stats/preprocess_stats_infill_local_markers_4chan.npz"
    ref, out = (_stats(str(tmp_path / n / stats)) for n in ("jax", "port"))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6)
    _check_history(hist["port"], hist["jax"],
                   ["total", "loss_rec_body", "loss_rec_body_v",
                    "loss_rec_contact_lbl"])


def test_load_prox_masks_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for rec, n in (("rec_a", 250), ("rec_b", 130)):
        (tmp_path / rec).mkdir()
        m = (rng.rand(n, 67) > rng.uniform(0.0, 0.2)).astype(np.float32)
        np.save(tmp_path / rec / "mask_markers.npy", m)
    ref = j_infill.load_prox_masks(str(tmp_path))
    out = t_infill.load_prox_masks(str(tmp_path))
    assert out.shape == ref.shape and out.shape[1:] == (120, 201)
    np.testing.assert_array_equal(out, ref)
    assert t_infill.load_prox_masks(str(tmp_path / "absent")) is None


def test_eval_amass_cli_matches_jax(corpus, tmp_path):
    root, common, vposer = corpus
    fits = tmp_path / "fits" / "TotalCapture"
    fits.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i in range(2):
        x72 = (rng.randn(29, 72) * 0.1).astype(np.float32)
        np.save(fits / f"body_params_opt_clip_{i}.npy", x72)
        np.save(fits / f"contact_lbl_rec_clip_{i}.npy",
                (rng.rand(29, 4) > 0.5).astype(np.float32))
    argv = common + ["--fitting_root", str(tmp_path / "fits"),
                     "--vposer_ckpt", vposer, "--step", "1"]
    j_eval.main(argv + ["--out", str(tmp_path / "jax.json")])
    t_eval.main(argv + ["--out", str(tmp_path / "port.json")], device="cpu")
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port.json") as f:
        out = json.load(f)
    assert set(out["clips"]) == set(ref["clips"]) == {"0", "1"}

    def numbers(d, path=()):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from numbers(v, path + (k,))
            elif isinstance(v, (int, float)):
                yield path + (k,), v

    ref_n, out_n = dict(numbers(ref)), dict(numbers(out))
    assert set(out_n) == set(ref_n)
    assert ("clips", "0", "foot_skate") in out_n
    for k, v in ref_n.items():
        assert np.isfinite(out_n[k])
        np.testing.assert_allclose(out_n[k], v, rtol=1e-4,
                                   err_msg=str(k))
