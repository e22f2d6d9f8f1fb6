"""The port's Holden transform and global reconstruction
(`lemo_tpu_torch.data.repr`) against the independent numpy oracle
(`lemo_tpu.testing.oracle_holden`, a test-only module the port needs no
copy of) at the golden `res_opt_amass_temp` production shapes ([119, 72]
params, [119, 4] contact labels, 67 markers), with
tests/test_parity_oracle.py's inputs and tolerances."""

import numpy as np
import pytest
import torch

from lemo_tpu.testing.oracle_holden import get_local_markers_4chan_np, \
    reconstruct_global_body_np
from lemo_tpu_torch.data.repr import local_markers_4chan, \
    reconstruct_global_body


def _smooth_trajectory(T=119, N=68, seed=5):
    """A smooth synthetic walking-scale trajectory [T, N, 3] z-up: random
    body offsets around a drifting, turning pelvis (row 0)."""
    rng = np.random.RandomState(seed)
    heading = np.cumsum(rng.randn(T) * 0.03)
    step = np.stack([np.cos(heading), np.sin(heading),
                     np.zeros(T)], 1) * 0.02
    pelvis = np.cumsum(step, axis=0) + np.array([0, 0, 0.9])
    offsets = rng.randn(1, N, 3) * 0.25
    wobble = 0.01 * np.sin(np.linspace(0, 8, T))[:, None, None] \
        * rng.randn(1, N, 3)
    body = pelvis[:, None, :] + offsets + wobble
    body[:, 0] = pelvis
    return body.astype(np.float32)


def _contact_lbls(T=119, seed=3):
    return (np.random.RandomState(seed).rand(T, 4) > 0.5).astype(np.float32)


@pytest.mark.parametrize("smooth", [False, True])
def test_4chan_image_matches_oracle(smooth):
    body, lbl = _smooth_trajectory(), _contact_lbls()
    img_t, rot0_t = local_markers_4chan(torch.as_tensor(body),
                                        torch.as_tensor(lbl),
                                        smooth_forward=smooth)
    img_n, rot0_n = get_local_markers_4chan_np(body, lbl,
                                               smooth_forward=smooth)
    assert img_t.shape == (4, 118, 68 * 3 + 4)
    np.testing.assert_allclose(img_t.numpy(), img_n, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(rot0_t), rot0_n, atol=1e-5)


def _stacked(img_n):
    """The oracle's image -> reconstruct_global_body's [T, 1+68+1, 3]
    input: zero row, local pose, trajectory row."""
    T1 = img_n.shape[1]
    local = img_n[0][:, :68 * 3].reshape(T1, 68, 3)
    traj = np.stack([img_n[1][:, 0], img_n[2][:, 0], img_n[3][:, 0]],
                    axis=1)[:, None, :]
    return np.concatenate([np.zeros((T1, 1, 3)), local, traj], axis=1)


def test_reconstruct_matches_oracle():
    """Decompose -> reconstruct, the port against the oracle at [119, ...]:
    the frame loop must integrate as the oracle does."""
    img_n, rot0 = get_local_markers_4chan_np(_smooth_trajectory(seed=9),
                                             _contact_lbls())
    stacked = _stacked(img_n)
    out_t = reconstruct_global_body(
        torch.as_tensor(stacked, dtype=torch.float32),
        torch.as_tensor(rot0, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(out_t, reconstruct_global_body_np(stacked,
                                                                 rot0),
                               atol=2e-4)


def test_joint_mode_matches_oracle():
    """The local_joints_4chan variant: [T, 25, 3] joints (pelvis row 0),
    shoulder/hip rows 16/17/1/2; the oracle adds two rows (reference and
    pelvis) to its slots, the joints carry their own pelvis, so it takes
    the slots less one."""
    body, lbl = _smooth_trajectory(N=25, seed=21), _contact_lbls()
    img_t, rot0_t = local_markers_4chan(
        torch.as_tensor(body), torch.as_tensor(lbl), smooth_forward=True,
        direction_slots=(16, 17, 1, 2))
    img_n, rot0_n = get_local_markers_4chan_np(body, lbl,
                                               smooth_forward=True,
                                               slots=(15, 16, 0, 1))
    assert img_t.shape == (4, 118, 25 * 3 + 4)
    np.testing.assert_allclose(img_t.numpy(), img_n, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(rot0_t), rot0_n, atol=1e-5)


def test_roundtrip_recovers_world_shape():
    """Oracle decompose -> port reconstruct returns the body up to the
    unobservable initial planar offset and the put-on-floor shift
    (tests/test_parity_oracle.py's 5e-3 m)."""
    body = _smooth_trajectory(seed=13)
    img_n, rot0 = get_local_markers_4chan_np(body, _contact_lbls())
    T1 = img_n.shape[1]
    rec = reconstruct_global_body(
        torch.as_tensor(_stacked(img_n), dtype=torch.float32),
        torch.as_tensor(rot0, dtype=torch.float32)).numpy()
    target = body[:T1] - body[:T1, :1, :] * np.array([1, 1, 0])
    got = rec - rec[:, :1, :] * np.array([1, 1, 0])
    target = target - np.array([0, 0, body[..., 2].min()])
    np.testing.assert_allclose(got, target, atol=5e-3)
