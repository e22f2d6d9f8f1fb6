"""Motion representations (port of `lemo_tpu/data/repr.py`; this slice
needs only the frame-0 normalizer)."""

from __future__ import annotations

import torch


def frame0_normalizer(joints_frame0: torch.Tensor):
    """Rotation/origin that puts frame-0 pelvis at the origin facing +y.

    joints_frame0: [J>=3, 3] (0 pelvis, 1/2 hips). Returns
    (transf_rotmat [3, 3], origin [3]); apply as (x - origin) @ R.
    """
    x_axis = joints_frame0[2] - joints_frame0[1]
    x_axis = torch.cat([x_axis[:2], torch.zeros_like(x_axis[2:])])
    x_axis = x_axis / torch.linalg.norm(x_axis)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=joints_frame0.dtype,
                          device=joints_frame0.device)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    y_axis = y_axis / torch.linalg.norm(y_axis)
    R = torch.stack([x_axis, y_axis, z_axis], dim=1)
    return R, joints_frame0[0]
