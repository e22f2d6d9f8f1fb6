"""Quaternion helpers, Holden conventions (port of
`lemo_tpu/ops/quaternions.py`; utils/Quaternions.py). Quaternions are
[..., 4] ordered (w, x, y, z)."""

from __future__ import annotations

import torch


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q (x) r, both [..., 4] (broadcastable)."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]
    (v + 2 (w u x v + u x (u x v)))."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """angle [...] + axis [..., 3] -> quaternion [..., 4], with the
    reference's 1e-10 axis-norm regularizer."""
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-10)
    half = angle[..., None] / 2.0
    axis = axis.expand(half.shape[:-1] + (3,))
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def between(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 into v1 (both [..., 3]): normalize([|v0||v1|
    + v0.v1, v0 x v1]) (`Quaternions.between`, utils/Quaternions.py:
    396-400), its antipodal pole included: v0 = -v1 gives the zero
    quaternion, which normalizes to NaN."""
    v0, v1 = torch.broadcast_tensors(v0, v1)
    a = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt((v0 ** 2).sum(-1) * (v1 ** 2).sum(-1)) + (v0 * v1).sum(-1)
    return qnormalize(torch.cat([w[..., None], a], dim=-1))


def pivot_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Heading angle about +y: rotate forward = +z by q, atan2(x, z)."""
    fwd = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    fwd[..., 2] = 1.0
    d = qrot(q, fwd)
    return torch.atan2(d[..., 0], d[..., 2])


def qid(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) with the given batch shape."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions
    (`Quaternions.slerp`, utils/Quaternions.py:376-394): shortest arc (q1
    flipped when the dot is negative), normalized lerp where the two are
    nearly parallel. `t` broadcasts against the batch shape."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs()
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    near = sin_t < 1e-6
    safe = torch.where(near, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] -> rotation matrices [..., 3, 3]
    (`Quaternions.transforms`, utils/Quaternions.py:339-360)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4]:
    branch-free Shepperd's method, each element selecting the stablest
    of the four decompositions (`Quaternions.from_transforms`,
    utils/Quaternions.py:424-455)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    s0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 2.0
    c0 = mk(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    c1 = mk((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2.0
    c2 = mk((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2.0
    c3 = mk((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    alt = torch.where(cond1[..., None], c1,
                      torch.where(cond2[..., None], c2, c3))
    return qnormalize(torch.where((tr > 0)[..., None], c0, alt))


def to_euler(q: torch.Tensor, order: str = "xyz") -> torch.Tensor:
    """Unit quaternions -> intrinsic euler angles [..., 3], for the 'xyz'
    and 'yzx' orders `Quaternions.euler` implements
    (utils/Quaternions.py:311-330); 'yzx' returns [theta_y, theta_z,
    theta_x], in the order string's order."""
    w, x, y, z = q.unbind(-1)
    if order == "xyz":
        ex = torch.atan2(2 * (x * w - y * z), 1 - 2 * (x * x + y * y))
        ey = torch.arcsin(torch.clamp(2 * (x * z + y * w), -1, 1))
        ez = torch.atan2(2 * (z * w - x * y), 1 - 2 * (y * y + z * z))
        return torch.stack([ex, ey, ez], dim=-1)
    if order == "yzx":
        ex = torch.atan2(2 * (x * w - z * y), 1 - 2 * (x * x + z * z))
        ey = torch.atan2(2 * (y * w - x * z), 1 - 2 * (y * y + z * z))
        ez = torch.arcsin(torch.clamp(2 * (x * y + z * w), -1, 1))
        return torch.stack([ey, ez, ex], dim=-1)
    raise NotImplementedError(f"euler order {order!r}")


def from_euler(e: torch.Tensor, order: str = "xyz") -> torch.Tensor:
    """Intrinsic euler angles [..., 3] -> unit quaternions, the per-axis
    quaternions composed in the given order (`Quaternions.from_euler`,
    utils/Quaternions.py:409-422, world=False)."""
    q = None
    for i, ax in enumerate(order):
        axis = torch.zeros(e.shape[:-1] + (3,), dtype=e.dtype,
                           device=e.device)
        axis[..., "xyz".index(ax)] = 1.0
        qi = from_angle_axis(e[..., i], axis)
        q = qi if q is None else qmul(q, qi)
    return q
