"""Per-vertex camera visibility by z-buffer (port of
`lemo_tpu/ops/visibility.py`), batched over frames.

Vertices are splatted into a coarse res x res pixel grid per frame; the
buffers are filled with `scatter_reduce_(..., "amin")` over one flat
[T * res * res] tensor, so all frames take one scatter. A vertex is
visible when it is within `eps` of its own cell's minimum depth, within
`eps_far` of the 3x3-dilated minimum, and (given normals) faces the
camera. Not differentiable: the reference detaches it too.
"""

from __future__ import annotations

import torch

_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
               (1, 0), (1, 1))


@torch.no_grad()
def visibility_zbuffer(verts: torch.Tensor, fx: float, fy: float,
                       cx: float, cy: float, width: int = 1920,
                       height: int = 1080, res: int = 256,
                       eps: float = 0.02,
                       normals: torch.Tensor | None = None,
                       eps_far: float = 0.1) -> torch.Tensor:
    """verts [V, 3] or [T, V, 3] in camera coordinates (+z forward) ->
    bool visibility of the same leading shape."""
    single = verts.dim() == 2
    if single:
        verts = verts[None]
        normals = None if normals is None else normals[None]
    T, V, _ = verts.shape
    z = verts[..., 2]
    valid = z > 1e-4
    zs = torch.where(valid, z, torch.ones_like(z))
    u = verts[..., 0] / zs * fx + cx
    v = verts[..., 1] / zs * fy + cy

    def cell(c, extent):
        # clamp in float first so the int conversion never overflows;
        # the result equals truncation followed by the clip to [0, res-1]
        t = torch.clamp(c / extent * res, min=-1.0, max=float(res))
        return torch.clamp(t.to(torch.int64), 0, res - 1)

    px, py = cell(u, width), cell(v, height)
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & valid
    base = (torch.arange(T, device=verts.device) * (res * res))[:, None]
    zput = torch.where(in_img, z, torch.full_like(z, float("inf")))

    def splat(ix, iy):
        idx = torch.where(in_img, iy * res + ix, torch.zeros_like(ix)) + base
        buf = torch.full((T * res * res,), float("inf"), dtype=verts.dtype,
                         device=verts.device)
        return buf.scatter_reduce_(0, idx.reshape(-1), zput.reshape(-1),
                                   reduce="amin", include_self=True)

    zbuf_own = splat(px, py)
    # the dilated buffer: every vertex also splats into its 8 neighbours
    nx = torch.stack([px] + [torch.clamp(px + dx, 0, res - 1)
                             for _, dx in _NEIGHBOURS])
    ny = torch.stack([py] + [torch.clamp(py + dy, 0, res - 1)
                             for dy, _ in _NEIGHBOURS])
    idx9 = torch.where(in_img, ny * res + nx, torch.zeros_like(nx)) + base
    zbuf_dil = torch.full((T * res * res,), float("inf"), dtype=verts.dtype,
                          device=verts.device).scatter_reduce_(
        0, idx9.reshape(-1), zput.expand(9, T, V).reshape(-1),
        reduce="amin", include_self=True)
    own = (py * res + px + base).reshape(-1)
    front = ((z <= zbuf_own[own].reshape(T, V) + eps)
             & (z <= zbuf_dil[own].reshape(T, V) + eps_far))
    if normals is not None:
        front = front & ((normals * (-verts)).sum(-1) > 0.0)
    out = in_img & front
    return out[0] if single else out


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals; verts [V, 3] or [T, V, 3],
    faces [F, 3] int64 on the same device."""
    single = verts.dim() == 2
    if single:
        verts = verts[None]
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)     # [T, F, 3]
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(1, faces[:, k], fn)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    out = vn / torch.clamp(norm, min=1e-12)
    return out[0] if single else out
