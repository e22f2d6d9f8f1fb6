"""Offline marker-occlusion mask generation (port of
`lemo_tpu/utils/occlusion_mask.py`; utils/get_occlusion_mask.py
capability).

For each frame of a fitted recording, mark the body markers whose
projected position is occluded by the scene: their depth lies behind the
scene's depth at that pixel by more than `margin`. The reference renders
scene depth with pyrender; here the scene's points are splatted into a
coarse z-buffer on the tensors' device, all frames at once. The z-buffer
is a scatter of minima, which does not depend on the order of the
writes, so the mask is deterministic.
"""

from __future__ import annotations

import torch


def _pixel(u: torch.Tensor, size: float, res: int) -> torch.Tensor:
    """Bucket of a pixel coordinate: int32 truncation toward zero of
    u / size * res, clipped to [0, res - 1]. The float clamp first keeps
    the conversion in range and changes no bucket."""
    b = torch.clamp(u / size * res, -1.0, float(res)).to(torch.int32)
    return torch.clamp(b, 0, res - 1)


def scene_zbuffer(scene_points_cam: torch.Tensor, fx: float, fy: float,
                  cx: float, cy: float, width: int = 1920,
                  height: int = 1080, res: int = 256) -> torch.Tensor:
    """[res * res] nearest scene depth of each pixel bucket (inf where no
    point falls), from scene points [S, 3] in camera coords."""
    z = scene_points_cam[:, 2]
    valid = z > 1e-4
    zs = torch.where(valid, z, torch.ones_like(z))
    u = scene_points_cam[:, 0] / zs * fx + cx
    v = scene_points_cam[:, 1] / zs * fy + cy
    px = _pixel(u, width, res)
    py = _pixel(v, height, res)
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & valid
    idx = torch.where(in_img, py * res + px, torch.zeros_like(px))
    inf = torch.full_like(z, float("inf"))
    return torch.full((res * res,), float("inf"), dtype=z.dtype,
                      device=z.device).scatter_reduce_(
        0, idx.long(), torch.where(in_img, z, inf), "amin")


def marker_buckets(markers_cam: torch.Tensor, fx: float, fy: float,
                   cx: float, cy: float, width: int = 1920,
                   height: int = 1080, res: int = 256):
    """(bucket index [T, M] into the z-buffer, inside-the-image mask
    [T, M]) of markers [T, M, 3] in camera coords."""
    mz = markers_cam[..., 2]
    ok = mz > 1e-4
    mzs = torch.where(ok, mz, torch.ones_like(mz))
    mu = markers_cam[..., 0] / mzs * fx + cx
    mv = markers_cam[..., 1] / mzs * fy + cy
    mpx = _pixel(mu, width, res)
    mpy = _pixel(mv, height, res)
    inside = (mu >= 0) & (mu < width) & (mv >= 0) & (mv < height) & ok
    return (mpy * res + mpx).long(), inside


def marker_occlusion_mask(
    markers_cam: torch.Tensor,       # [T, M, 3] markers in camera coords
    scene_points_cam: torch.Tensor,  # [S, 3] scene points in camera coords
    fx: float, fy: float, cx: float, cy: float,
    width: int = 1920, height: int = 1080,
    res: int = 256,
    margin: float = 0.1,
) -> torch.Tensor:
    """[T, M] float32 mask, 1 = visible, 0 = occluded by scene depth
    (utils/get_occlusion_mask.py:39-241 semantics: occluded when marker
    depth > scene depth + 0.1 m at its pixel)."""
    zbuf = scene_zbuffer(scene_points_cam, fx, fy, cx, cy, width, height,
                         res)
    idx, inside = marker_buckets(markers_cam, fx, fy, cx, cy, width, height,
                                 res)
    occluded = inside & (markers_cam[..., 2] > zbuf[idx] + margin)
    return torch.where(occluded, 0.0, 1.0).to(torch.float32)
