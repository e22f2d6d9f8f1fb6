"""Quaternion helpers, Holden conventions (port of the part of
`lemo_tpu/ops/quaternions.py` that `data/repr.py` uses). Quaternions are
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


def pivot_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Heading angle about +y: rotate forward = +z by q, atan2(x, z)."""
    fwd = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    fwd[..., 2] = 1.0
    d = qrot(q, fwd)
    return torch.atan2(d[..., 0], d[..., 2])
