"""The plain reference against lemo_tpu_torch at small sizes on the CPU
(the test imports both; the reference imports nothing of the program)."""

import numpy as np
import pytest
import torch

from portbench import synth
from portbench.reference.smplx import Smplx, vposer_decode
from portbench.tests.conftest import AMASS_SMALL


@pytest.fixture(scope="module")
def model_raw():
    return synth.smplx_model(synth.generator(3, "cpu"), "cpu")


def test_smplx_forward_is_the_programs(model_raw):
    from lemo_tpu_torch.body_model import load_model, make_forward_fn

    g = torch.Generator().manual_seed(0)
    B = 6
    p = {"transl": torch.randn(B, 3, generator=g),
         "global_orient": 0.5 * torch.randn(B, 3, generator=g),
         "body_pose": 0.3 * torch.randn(B, 63, generator=g),
         "left_hand_pose": torch.randn(B, 12, generator=g),
         "right_hand_pose": torch.randn(B, 12, generator=g),
         "betas": torch.randn(B, 10, generator=g)}
    model = load_model(synth.to_numpy(model_raw), use_pca=True,
                       num_pca_comps=12, device="cpu")
    z3 = torch.zeros(B, 3)
    out = make_forward_fn(model)(dict(p, jaw_pose=z3, leye_pose=z3,
                                      reye_pose=z3,
                                      expression=torch.zeros(B, 10)),
                                 model.consts)
    verts, joints = Smplx(model_raw).forward(
        p["transl"], p["global_orient"], p["body_pose"],
        p["left_hand_pose"], p["right_hand_pose"], p["betas"])
    assert torch.allclose(verts, out["vertices"], atol=2e-5)
    assert torch.allclose(joints, out["joints"][:, :55], atol=2e-5)


def test_vposer_decode_is_the_programs():
    from lemo_tpu_torch.body_model import vposer

    vpp = synth.vposer_decoder(synth.generator(4, "cpu"), "cpu")
    z = torch.randn(7, 32, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(vposer_decode(vpp, z),
                          vposer.decode(vpp, z, "aa"), atol=1e-5)


def test_smooth_encoder_is_the_programs():
    from lemo_tpu_torch.priors.conv_ae import smooth_enc_forward
    from portbench.reference.amass_stage2 import smooth_encoder

    enc = synth.smooth_encoder(synth.generator(5, "cpu"), "cpu")
    x = torch.randn(2, 1, 245, 40, generator=torch.Generator().manual_seed(2))
    want, _ = smooth_enc_forward(enc, x, downsample=False)
    assert torch.allclose(smooth_encoder(enc, x), want, atol=1e-5)


def test_stage2_fit_is_the_programs():
    """The whole Stage-2 fit of two clips, the program's fold against the
    reference, through the cell's own runner (4 steps of 20 frames)."""
    from portbench.run import load_cell
    from portbench.runners.smplx_amass_stage2 import Runner

    _, _, cell, config = load_cell("amass_s2.c16")
    for k, v in AMASS_SMALL.items():
        (cell if k in cell else config)[k] = v
    r = Runner(config, cell, 2**31 + 11, "cpu")
    r.setup()
    r.call(0)
    ids, x72, losses = r.sample()
    r.release()
    num = r.numbers(ids, x72, losses, *r.reference_fit(ids))
    assert num["loss0_gap"] < 1e-5
    assert num["fold3_gap"] < 1e-5
    assert num["loss3_gap"] < 1e-5
    assert num["loss_gap"] < 1e-5
    assert num["move_gap"] < 1e-3
    assert np.isfinite(losses.numpy()).all()
