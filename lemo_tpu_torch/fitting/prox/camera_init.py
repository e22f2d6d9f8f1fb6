"""Camera / body-translation initialization for PROX fitting (port of
`lemo_tpu/fitting/prox/camera_init.py`): the SMPLify-X init stage the
reference carries, `guess_init` (fitting_temp_slide.py:59-133, a depth
estimate from 2D/3D limb-length ratios) and `SMPLifyCameraInitLoss`
(fitting_temp_slide.py:1066-1123, a torso-keypoint and depth-regularized
translation fit).

A library function: no driver path calls it, in `lemo_tpu` as here.
"""

from __future__ import annotations

import torch

from lemo_tpu_torch.fitting.adam import adam_init, adam_minimize

# torso edges used for the focal-length depth guess (main SMPLify-X
# convention: shoulders/hips in OpenPose numbering)
DEFAULT_EDGE_IDXS = ((5, 12), (2, 9))
# torso joints for the init loss (cmd_parser default init_joints_idxs)
DEFAULT_INIT_JOINTS = (9, 12, 2, 5)


def guess_init_depth(joints_3d: torch.Tensor, joints_2d: torch.Tensor,
                     focal_length: float = 5000.0,
                     edge_idxs=DEFAULT_EDGE_IDXS) -> torch.Tensor:
    """Estimate camera/body depth from limb-length ratios.

    joints_3d [B, K, 3] (model joints at init pose), joints_2d [B, K, 2]
    detections. Returns init translation [B, 3] = (0, 0, f * h3d/h2d).
    """
    d3 = torch.stack([joints_3d[:, a] - joints_3d[:, b]
                      for a, b in edge_idxs], 1)
    d2 = torch.stack([joints_2d[:, a] - joints_2d[:, b]
                      for a, b in edge_idxs], 1)
    l3 = torch.linalg.norm(d3, dim=-1).mean(dim=1)                 # [B]
    l2 = torch.linalg.norm(d2, dim=-1).mean(dim=1)
    est_d = focal_length * (l3 / torch.clamp(l2, min=1e-6))
    zeros = torch.zeros_like(est_d)
    return torch.stack([zeros, zeros, est_d], dim=1)


def camera_init_loss(proj_joints: torch.Tensor, gt_joints: torch.Tensor,
                     transl: torch.Tensor,
                     trans_estimation: torch.Tensor | None,
                     init_joints_idxs=DEFAULT_INIT_JOINTS,
                     data_weight: float = 1.0,
                     depth_loss_weight: float = 1e2) -> torch.Tensor:
    """Torso-joint squared reprojection + depth regularization
    (SMPLifyCameraInitLoss.forward, camera_mode='fixed')."""
    idx = list(init_joints_idxs)
    err = (gt_joints[:, idx] - proj_joints[:, idx]) ** 2
    loss = err.sum() * data_weight ** 2
    if trans_estimation is not None:
        loss = loss + depth_loss_weight ** 2 * (
            (transl[:, 2] - trans_estimation[:, 2]) ** 2).sum()
    return loss


def fit_camera_init(forward_fn, consts, joint_mapper, camera,
                    init_params: dict, gt_joints: torch.Tensor,
                    trans_estimation: torch.Tensor | None = None,
                    num_steps: int = 30, lr: float = 0.01):
    """Optimize global translation/orientation against torso keypoints
    before the main fit: `num_steps` of Adam (optax's defaults) over
    {transl, global_orient}, the other parameters frozen. Returns
    ({transl, global_orient}, per-step losses [num_steps]), on the
    device."""
    jm = torch.as_tensor(joint_mapper, dtype=torch.int64,
                         device=gt_joints.device)
    opt_vars = {"transl": init_params["transl"],
                "global_orient": init_params["global_orient"]}
    frozen = {k: v for k, v in init_params.items() if k not in opt_vars}

    def loss_fn(v):
        out = forward_fn({**frozen, **v}, consts)
        proj = camera.project(out["joints"].index_select(1, jm))
        return camera_init_loss(proj, gt_joints, v["transl"],
                                trans_estimation), {}

    state = adam_init(opt_vars)
    losses = []
    for _ in range(num_steps):
        opt_vars, metrics = adam_minimize(loss_fn, opt_vars, state, lr)
        losses.append(metrics["total"])
    return opt_vars, torch.stack(losses)
