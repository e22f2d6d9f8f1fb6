"""Evaluation metrics for fitted sequences (port of
`lemo_tpu/utils/metrics.py`): marker error, MPJPE, acceleration error
and foot skate, on tensors.

The reference exposes the GT hooks (the fitting loader returns world
transforms and GT smplx params, optimize_loader_amass_new.py:283-308)
but computes the paper's accuracy numbers offline.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_world_transform(points: torch.Tensor, transf: torch.Tensor):
    """[..., 3] points through a [4, 4] homogeneous transform (the GT
    transform the fitting loader returns)."""
    return points @ transf[:3, :3].T + transf[:3, 3]


def _median(x: torch.Tensor) -> float:
    """numpy's median: the mean of the two middle values of an even
    count (torch.median takes the lower one)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return float(s[n // 2]) if n % 2 else float((s[n // 2 - 1]
                                                 + s[n // 2]) / 2)


def marker_error(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """Mean / median / max Euclidean error over [..., M, 3] marker sets."""
    d = torch.linalg.norm(pred - gt, dim=-1)
    return {"mean": float(d.mean()), "median": _median(d),
            "max": float(d.max())}


def mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
          align_root: bool = False) -> float:
    """Mean per-joint position error [T, J, 3]; optional root alignment."""
    if align_root:
        pred_joints = pred_joints - pred_joints[:, :1]
        gt_joints = gt_joints - gt_joints[:, :1]
    return float(torch.linalg.norm(pred_joints - gt_joints, dim=-1).mean())


def accel_error(pred: torch.Tensor, gt: torch.Tensor,
                fps: float = 30.0) -> float:
    """Mean acceleration-magnitude difference, the temporal-smoothness
    accuracy measure of motion-prior evaluations."""
    def accel(x):
        return (x[2:] - 2 * x[1:-1] + x[:-2]) * fps * fps

    return float(torch.linalg.norm(accel(pred) - accel(gt), dim=-1).mean())


def foot_skate(verts: torch.Tensor, contact_lbl: torch.Tensor,
               foot_ids: dict, fps: float = 30.0,
               thresh: float = 0.1) -> float:
    """Fraction of labelled-contact foot-vertex frames whose speed exceeds
    `thresh` m/s (the artifact the friction losses suppress)."""
    vel = torch.linalg.norm((verts[1:] - verts[:-1]) * fps, dim=-1)
    total, skate = 0.0, 0.0
    for i, part in enumerate(["left_heel", "right_heel", "left_toe",
                              "right_toe"]):
        ids = torch.as_tensor(np.asarray(foot_ids[part]),
                              device=verts.device)
        v = vel[:, ids]
        w = contact_lbl[:-1, i][:, None]
        skate += float(((v > thresh) * w).sum())
        total += float((torch.ones_like(v) * w).sum())
    return skate / max(total, 1.0)
