"""Rotation representation conversions on torch tensors.

Port of `lemo_tpu/ops/rotations.py`: the same formulas, branch-free and
differentiable, with the reference's `norm(aa + 1e-8)` Rodrigues
regularization and NaN-safe `sqrt(x + 1e-24)` norms at the identity.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def aa_to_matrot(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] (Rodrigues)."""
    batch_shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = torch.linalg.norm(aa + _EPS, dim=1, keepdim=True)  # [N, 1]
    rot_dir = aa / angle

    cos = torch.cos(angle)[:, None]  # [N, 1, 1]
    sin = torch.sin(angle)[:, None]

    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1
    ).reshape(-1, 3, 3)

    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)[None]
    rot = ident + sin * K + (1.0 - cos) * torch.matmul(K, K)
    return rot.reshape(*batch_shape, 3, 3)


def aa_to_matrot_planes(p: torch.Tensor) -> torch.Tensor:
    """Plane-major Rodrigues: axis-angle planes [3, J, B] -> rotation
    planes [9, J, B] (row k = 3m+n holds R[m, n]); elementwise, same
    `aa + 1e-8` regularization as :func:`aa_to_matrot`."""
    x = p[0] + _EPS
    y = p[1] + _EPS
    z = p[2] + _EPS
    angle = torch.sqrt(x * x + y * y + z * z)
    rx, ry, rz = x / angle, y / angle, z / angle
    s = torch.sin(angle)
    c = torch.cos(angle)
    C = 1.0 - c
    return torch.stack([
        c + C * rx * rx, -s * rz + C * rx * ry, s * ry + C * rx * rz,
        s * rz + C * rx * ry, c + C * ry * ry, -s * rx + C * ry * rz,
        -s * ry + C * rx * rz, s * rx + C * ry * rz, c + C * rz * rz,
    ])


def matrot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y, z).

    Branchless Shepperd-style conversion: all four candidates, the one
    with the largest diagonal combination selected.
    """
    batch_shape = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    # each candidate's own component is the sqrt; the other three are
    # divided by 4x it (JAX sets the own slot after the division)
    w_w = _safe_sqrt(qw2) * 0.5
    q_w = torch.stack([w_w, (m21 - m12) / (4.0 * w_w),
                       (m02 - m20) / (4.0 * w_w),
                       (m10 - m01) / (4.0 * w_w)], dim=1)
    x_x = _safe_sqrt(qx2) * 0.5
    q_x = torch.stack([(m21 - m12) / (4.0 * x_x), x_x,
                       (m01 + m10) / (4.0 * x_x),
                       (m02 + m20) / (4.0 * x_x)], dim=1)
    y_y = _safe_sqrt(qy2) * 0.5
    q_y = torch.stack([(m02 - m20) / (4.0 * y_y),
                       (m01 + m10) / (4.0 * y_y), y_y,
                       (m12 + m21) / (4.0 * y_y)], dim=1)
    z_z = _safe_sqrt(qz2) * 0.5
    q_z = torch.stack([(m10 - m01) / (4.0 * z_z),
                       (m02 + m20) / (4.0 * z_z),
                       (m12 + m21) / (4.0 * z_z), z_z], dim=1)

    scores = torch.stack([qw2, qx2, qy2, qz2], dim=1)  # [N, 4]
    choice = torch.argmax(scores, dim=1)  # [N]
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=1)  # [N, 4, 4]
    q = torch.gather(cands, 1, choice[:, None, None].expand(-1, 1, 4))[:, 0]
    # canonical sign: w >= 0
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    return q.reshape(*batch_shape, 4)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] (w, x, y, z) -> axis-angle [..., 3]."""
    batch_shape = q.shape[:-1]
    q = q.reshape(-1, 4)
    w = torch.clamp(q[:, 0], -1.0, 1.0)
    xyz = q[:, 1:]
    # sqrt(x + eps), not linalg.norm: d norm / d xyz is NaN at xyz == 0
    # and would survive the where() below through the chain rule
    sin_half = torch.sqrt((xyz ** 2).sum(dim=1) + 1e-24)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < _EPS, 2.0,
                        angle / torch.clamp(sin_half, min=_EPS))
    return (xyz * scale[:, None]).reshape(*batch_shape, 3)


def matrot_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3] (via the
    quaternion, like the reference's `matrot2aa`)."""
    return quat_to_aa(matrot_to_quat(R))


def rot6d_to_matrot(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6-D representation [..., 6] -> matrices [..., 3, 3]
    (Gram-Schmidt on the first two columns, stored row-interleaved)."""
    batch_shape = x.shape[:-1]
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[:, :, 0], m[:, :, 1]
    # sqrt(x + eps) norms: NaN-free gradients at a degenerate input
    b1 = a1 / torch.sqrt((a1 ** 2).sum(dim=1, keepdim=True) + 1e-24)
    dot = torch.sum(b1 * a2, dim=1, keepdim=True)
    b2u = a2 - dot * b1
    b2 = b2u / torch.sqrt((b2u ** 2).sum(dim=1, keepdim=True) + 1e-24)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    R = torch.stack([b1, b2, b3], dim=-1)  # columns
    return R.reshape(*batch_shape, 3, 3)


def matrot_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> 6-D representation [..., 6]
    (the first two columns)."""
    batch_shape = R.shape[:-2]
    return R.reshape(*batch_shape, 9)[..., [0, 1, 3, 4, 6, 7]]


def aa_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> 6-D representation [..., 6]."""
    return matrot_to_rot6d(aa_to_matrot(aa))


def rot6d_to_aa(x: torch.Tensor) -> torch.Tensor:
    """6-D representation [..., 6] -> axis-angle [..., 3]."""
    return matrot_to_aa(rot6d_to_matrot(x))


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] + translation [..., 3] -> homogeneous
    [..., 4, 4] (smplx `transform_mat`, reference lbs.py:196-205)."""
    batch_shape = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    t = t.reshape(-1, 3, 1)
    top = torch.cat([R, t], dim=2)  # [N, 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1).reshape(*batch_shape, 4, 4)


def pack_params_6d(x72: torch.Tensor) -> torch.Tensor:
    """[T, 72] body params (transl 3 + axis-angle rot 3 + rest) -> [T, 75]
    with the 6-D rotation (`convert_to_6D_rot`, utils/utils.py:94-107)."""
    xt, xr, xb = x72[:, :3], x72[:, 3:6], x72[:, 6:]
    return torch.cat([xt, aa_to_rot6d(xr), xb], dim=-1)


def unpack_params_6d(x75: torch.Tensor) -> torch.Tensor:
    """[T, 75] (transl 3 + rot6d + rest) -> [T, 72] with the axis-angle
    rotation (`convert_to_3D_rot`, utils/utils.py:111-123)."""
    xt, xr, xb = x75[:, :3], x75[:, 3:9], x75[:, 9:]
    return torch.cat([xt, rot6d_to_aa(xr), xb], dim=-1)


def rotate_by_matrix(points: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Apply a [3, 3] rotation to [..., 3] points (the right-multiply
    convention `p @ R` the reference uses for frame-0 normalization)."""
    return torch.matmul(points, R)


def batched_aa_to_matrot(aa: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> [B, N, 3, 3]: `lemo_tpu`'s vmap of `aa_to_matrot` over
    the leading axis, which `aa_to_matrot` already takes as a batch
    axis."""
    return aa_to_matrot(aa)
