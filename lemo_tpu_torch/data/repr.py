"""Motion representations (port of `lemo_tpu/data/repr.py`): the
frame-0 normalization, foot-contact labels, the flat clip images of the
smoothness prior, the local (Holden-style) motion images of the infill
prior and the global-trajectory reconstruction. Conventions kept exactly:
the y/z swap into (x, up, fwd), the floor shift, the reference-joint
trajectory and pivot angles about +y."""

from __future__ import annotations

import torch

from lemo_tpu_torch.data import markers as mk
from lemo_tpu_torch.ops import quaternions as quat
from lemo_tpu_torch.ops.signal import gaussian_filter1d_nearest


def frame0_normalizer(joints_frame0: torch.Tensor):
    """Rotation/origin that puts frame-0 pelvis at the origin facing +y.

    joints_frame0: [..., J>=3, 3] (0 pelvis, 1/2 hips). Returns
    (transf_rotmat [..., 3, 3], origin [..., 3]); apply as
    (x - origin) @ R.
    """
    x_axis = joints_frame0[..., 2, :] - joints_frame0[..., 1, :]
    x_axis = torch.cat([x_axis[..., :2], torch.zeros_like(x_axis[..., 2:])],
                       dim=-1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    # +z made on the device (no copy from the host: a captured step
    # cannot hold one)
    z_axis = torch.zeros_like(x_axis)
    z_axis[..., 2] = 1.0
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    y_axis = y_axis / torch.linalg.norm(y_axis, dim=-1, keepdim=True)
    R = torch.stack([x_axis, y_axis, z_axis], dim=-1)
    return R, joints_frame0[..., 0, :]


def normalize_to_frame0(points: torch.Tensor,
                        joints_frame0: torch.Tensor) -> torch.Tensor:
    """Apply the frame-0 normalizer to a [T, N, 3] trajectory."""
    R, origin = frame0_normalizer(joints_frame0)
    return torch.matmul(points - origin, R)


def contact_labels_from_markers(markers: torch.Tensor, fps: float = 30.0,
                                vel_thresh: float = 0.22,
                                z_margin: float = 0.10) -> torch.Tensor:
    """Binary foot-contact labels [T, 4] (lheel, rheel, ltoe, rtoe) from
    markers [T, 67, 3] in a z-up frame: speed < 0.22 m/s and height below
    min + 0.10 m; the last frame uses the height test only
    (train_loader_infill.py:175-200)."""
    feet = markers[:, torch.as_tensor(mk.FOOT_MARKER_SLOTS,
                                      device=markers.device)]  # [T, 4, 3]
    vel = torch.linalg.norm((feet[1:] - feet[:-1]) * fps, dim=-1)
    vel_contact = (vel.abs() < vel_thresh).to(markers.dtype)
    vel_contact = torch.cat([vel_contact, torch.zeros_like(vel_contact[:1])])
    z_thres = markers[:, :, -1].min() + z_margin
    height_contact = (feet[:, :, 2] < z_thres).to(markers.dtype)
    lbl = vel_contact * height_contact
    return torch.cat([lbl[:-1], height_contact[-1:]])


def _forward_direction(body_xzy, sdr_l, sdr_r, hip_l, hip_r,
                       smooth: bool, filterwidth: int = 20):
    across = (body_xzy[:, sdr_r] - body_xzy[:, sdr_l]) + (
        body_xzy[:, hip_r] - body_xzy[:, hip_l])
    across = across / torch.clamp(
        torch.linalg.norm(across, dim=-1, keepdim=True), min=1e-12)
    up = torch.tensor([[0.0, 1.0, 0.0]], dtype=body_xzy.dtype,
                      device=body_xzy.device).expand_as(across)
    forward = torch.linalg.cross(across, up, dim=-1)
    if smooth:
        forward = gaussian_filter1d_nearest(forward, float(filterwidth),
                                            axis=0)
    return forward / torch.clamp(
        torch.linalg.norm(forward, dim=-1, keepdim=True), min=1e-12)


def local_markers_4chan(pelvis_and_markers: torch.Tensor,
                        contact_lbls: torch.Tensor,
                        smooth_forward: bool = False,
                        direction_slots: tuple | None = None):
    """Holden-style local 4-channel motion image: utils/utils.py:209-265
    (`smooth_forward=False`, the fitters' variant) and
    train_loader_infill.py:216-275 (`smooth_forward=True`, the forward
    direction smoothed over time by a Gaussian of width 20 frames).

    pelvis_and_markers [T, 1+67, 3] z-up (row 0 the pelvis joint);
    contact_lbls [T, 4] -> (img [4, T-1, d=(1+67)*3+4], rot_0_pivot).
    `direction_slots` are the shoulder/hip rows (left, right, left, right)
    of the input array; the marker default is each marker slot + 1 for
    the pelvis row (joint modes pass joint indices). The heading is
    removed by a rotation about +y of -atan2(f_x, f_z), which equals the
    reference's `Quaternions.between(forward, z)` and stays finite where
    that one is NaN (forward = -z)."""
    dev, dt = pelvis_and_markers.device, pelvis_and_markers.dtype
    swap = torch.tensor([0, 2, 1], device=dev)
    body = pelvis_and_markers[:, :, swap]                 # (x, up, fwd)
    body = torch.stack([body[..., 0], body[..., 1] - body[..., 1].min(),
                        body[..., 2]], dim=-1)
    reference = body[:, 0] * torch.tensor([1.0, 0.0, 1.0], dtype=dt,
                                          device=dev)
    body = torch.cat([reference[:, None], body], dim=1)   # [T, 2+67, 3]
    velocity = body[1:, 0:1] - body[:-1, 0:1]             # [T-1, 1, 3]
    body = torch.stack([body[..., 0] - body[:, 0:1, 0], body[..., 1],
                        body[..., 2] - body[:, 0:1, 2]], dim=-1)
    sdr_l, sdr_r, hip_l, hip_r = direction_slots or (
        mk.SDR_L + 1, mk.SDR_R + 1, mk.HIP_L + 1, mk.HIP_R + 1)
    fwd = _forward_direction(body, sdr_l + 1, sdr_r + 1, hip_l + 1,
                             hip_r + 1, smooth_forward)
    theta = torch.atan2(fwd[:, 0], fwd[:, 2])
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    rotation = quat.from_angle_axis(-theta, y_axis)        # [T, 4]
    body = quat.qrot(rotation[:, None, :], body)
    velocity = quat.qrot(rotation[1:, None, :], velocity)
    rvelocity = quat.pivot_from_quaternion(
        quat.qmul(rotation[1:], quat.qconj(rotation[:-1])))   # [T-1]
    rot_0_pivot = quat.pivot_from_quaternion(rotation[0])
    body = body[:, :, swap]
    local = body[:-1, 1:, :].reshape(body.shape[0] - 1, -1)
    chan_local = torch.cat([local, contact_lbls[:-1]], dim=-1)   # [T-1, d]
    d = chan_local.shape[-1]
    n = velocity.shape[0]
    gx = velocity[:, :, 0].expand(n, d)
    gy = velocity[:, :, 2].expand(n, d)
    gr = rvelocity[:, None].expand(n, d)
    return torch.stack([chan_local, gx, gy, gr]), rot_0_pivot


def local_markers_flat(pelvis_and_markers: torch.Tensor,
                       contact_lbls: torch.Tensor,
                       smooth_forward: bool = False):
    """Single-channel local representation [T-1, 3 + (1+67)*3 + 4]:
    [global vel x, y, rot vel | local pose | contact labels], the
    'local_markers' mode (train_loader_infill.py:261-264). Returns
    (flat image, rot_0_pivot)."""
    img4, rot0 = local_markers_4chan(pelvis_and_markers, contact_lbls,
                                     smooth_forward=smooth_forward)
    gvel = torch.stack([img4[1][:, 0], img4[2][:, 0], img4[3][:, 0]], dim=1)
    return torch.cat([gvel, img4[0]], dim=-1), rot0


def local_joint_image(joints: torch.Tensor,
                      joints_frame0: torch.Tensor) -> torch.Tensor:
    """[T, K, 3] joints -> pelvis-relative flat image [T, K*3]
    (mode='local_joints', train_loader_smooth.py:158-162)."""
    j = normalize_to_frame0(joints, joints_frame0)
    rel = torch.cat([j[:, :1], j[:, 1:] - j[:, 0:1]], dim=1)
    return rel.reshape(rel.shape[0], -1)


def global_marker_image(markers: torch.Tensor,
                        joints_frame0: torch.Tensor) -> torch.Tensor:
    """[T, n, 3] markers -> frame-0-normalized flat clip image [T, n*3]
    (the smoothness-prior representation, train_loader_smooth.py:164-167).
    """
    m = normalize_to_frame0(markers, joints_frame0)
    return m.reshape(m.shape[0], -1)


def reconstruct_global_body(body_joints: torch.Tensor,
                            rot_0_pivot: torch.Tensor) -> torch.Tensor:
    """Integrate per-frame root motion back to world coordinates
    (utils/utils.py:184-203). body_joints [T, 1+N+1, 3] = zero row +
    local (pelvis + markers) + trajectory row (vel_x, vel_y, rot_vel) ->
    [T, N+1, 3], z-up. A loop over frames carrying (heading quaternion,
    planar translation), as `lemo_tpu`'s lax.scan does."""
    dev, dt = body_joints.device, body_joints.dtype
    swap = torch.tensor([0, 2, 1], device=dev)
    root = body_joints[:, -1]
    root_r, root_x, root_z = root[:, 2], root[:, 0], root[:, 1]
    body = body_joints[:, :-1][:, :, swap]
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    rotation = quat.from_angle_axis(-rot_0_pivot.reshape(()), y_axis)
    translation = torch.zeros(3, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    out = []
    for i in range(body.shape[0]):
        o = quat.qrot(rotation[None, :], body[i])
        out.append(torch.stack([o[:, 0] + translation[0], o[:, 1],
                                o[:, 2] + translation[2]], dim=-1))
        rotation = quat.qmul(quat.from_angle_axis(-root_r[i], y_axis),
                             rotation)
        step = quat.qrot(rotation[None, :],
                         torch.stack([root_x[i], zero, root_z[i]])[None])[0]
        translation = translation + step
    return torch.stack(out)[:, :, swap][:, 1:, :]
