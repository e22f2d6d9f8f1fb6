"""The port's small utilities against lemo_tpu's: the limb tables of
`utils/viz.py` (its drawings are held in test_torch_plot3d.py),
`utils/tools.py` (helpers, `load_vposer`'s (mtime, path) order),
`utils/profiling.py` on the CPU, and the vis_opt_amass CLI (the rebuilt
markers within 1e-5 m of lemo_tpu's, the sheet drawn)."""

import os

import jax
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.cli import vis_opt_amass as j_vis
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu.utils import tools as JT
from lemo_tpu.utils import viz as JV
from lemo_tpu_torch.cli import vis_opt_amass as t_vis
from lemo_tpu_torch.utils import profiling as TP
from lemo_tpu_torch.utils import tools as TT
from lemo_tpu_torch.utils import viz as TV

torch.set_num_threads(2)

def test_limb_tables_match():
    assert TV.LIMBS_MARKER_SSM2 == JV.LIMBS_MARKER_SSM2
    assert TV.LIMBS_BODY == JV.LIMBS_BODY


def test_helpers(tmp_path, capsys):
    assert TT.rel_change(10.0, 5.0) == JT.rel_change(10.0, 5.0) == 0.5
    assert TT.rel_change(0.2, 0.1) == JT.rel_change(0.2, 0.1)
    g = np.array([-3.0, 2.0])
    assert TT.max_grad_change(torch.as_tensor(g)) == \
        JT.max_grad_change(g) == 3.0
    assert len(TT.id_generator(8)) == 8
    x = torch.arange(6.0, requires_grad=True).reshape(2, 3)
    np.testing.assert_array_equal(TT.copy2cpu(x), JT.copy2cpu(
        np.arange(6.0).reshape(2, 3)))
    TT.makepath(str(tmp_path / "a" / "b.txt"), isfile=True)
    assert os.path.isdir(tmp_path / "a")
    TT.log2file(str(tmp_path / "run.log"), prefix="> ")("hello")
    assert open(tmp_path / "run.log").read() == "> hello\n"
    assert "> hello" in capsys.readouterr().out


def test_load_vposer_takes_the_newest_snapshot(tmp_path):
    """Newest by mtime, not by name; ties broken by the path, as in
    lemo_tpu (model_loader.py:50)."""
    snaps = tmp_path / "snapshots"
    snaps.mkdir()
    params = [j_vp.init_vposer(jax.random.PRNGKey(k)) for k in range(3)]
    for k, name in enumerate(("a.pt", "z.pt", "b.pkl")):
        torch.save({n: torch.as_tensor(np.array(v))
                    for n, v in params[k].items()}, snaps / name)
    os.utime(snaps / "a.pt", (3000, 3000))     # the newest
    os.utime(snaps / "z.pt", (1000, 1000))
    os.utime(snaps / "b.pkl", (2000, 2000))
    got, path = TT.load_vposer(str(tmp_path), device="cpu")
    ref, ref_path = JT.load_vposer(str(tmp_path))
    assert path == ref_path == str(snaps / "a.pt")
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    os.utime(snaps / "z.pt", (3000, 3000))     # a tie: the larger path
    assert TT.load_vposer(str(tmp_path), "cpu")[1] == \
        JT.load_vposer(str(tmp_path))[1] == str(snaps / "z.pt")
    with pytest.raises(FileNotFoundError):
        TT.load_vposer(str(tmp_path / "none"), "cpu")


def test_profiling_on_the_cpu(tmp_path):
    lines = []
    with TP.wallclock("step", sink=lines.append, device="cpu"):
        torch.ones(4).sum()
    assert lines and lines[0].startswith("[step] ")
    with TP.profile_trace(str(tmp_path)):
        with TP.annotate("s2_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = open(tmp_path / "trace.json").read()
    assert "s2_step" in trace and "aten::mm" in trace


@pytest.fixture(scope="module")
def amass_fit(tmp_path_factory):
    """A Stage-2 result folder (clip 0, female; clip 1, male) and a model
    directory of both genders."""
    root = tmp_path_factory.mktemp("vis")
    models = root / "models"
    models.mkdir()
    for g in ("male", "female"):
        np.savez(models / f"SMPLX_{g.upper()}.npz",
                 **synthetic_smplx_npz(num_verts=536, gender=g, seed=5))
    d = root / "res" / "TotalCapture"
    d.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i in range(2):
        x = (rng.randn(24, 72) * 0.3).astype(np.float32)
        np.save(d / f"body_params_opt_clip_{i}.npy", x)
        np.save(d / f"contact_lbl_rec_clip_{i}.npy",
                (rng.rand(24, 4) > 0.5).astype(np.float32))
    np.save(d / "gender_list.npy", np.array([0, 1]))
    vposer = str(root / "vposer.pt")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in
                j_vp.init_vposer(jax.random.PRNGKey(0)).items()}, vposer)
    return root, models, vposer


@pytest.mark.parametrize("clip", [0, 1])
def test_vis_opt_amass_matches(amass_fit, clip, tmp_path, monkeypatch):
    root, models, vposer = amass_fit
    argv = ["--res_dir", str(root / "res"), "--body_model_path",
            str(models), "--clip_id", str(clip), "--vposer_ckpt", vposer]
    drawn = []
    real = JV.save_marker_animation

    def spy(markers, out, contact=None, **kw):
        drawn.append((np.asarray(markers), contact))
        return real(markers, out, contact, **kw)

    monkeypatch.setattr(JV, "save_marker_animation", spy)
    j_vis.main(argv + ["--out", str(tmp_path / "j.png")])
    out = t_vis.main(argv + ["--out", str(tmp_path / "t.png")],
                     device="cpu")
    assert out == str(tmp_path / "t.png") and os.path.getsize(out) > 1000
    markers, contact = t_vis.rebuild_markers(
        t_vis.build_parser().parse_args(argv), "cpu")
    (ref, ref_contact), = drawn
    assert markers.shape == ref.shape == (24, 67, 3)
    np.testing.assert_allclose(markers, ref, atol=1e-5)
    np.testing.assert_array_equal(contact, ref_contact)
