"""Dependency-free software rasterizer for result rendering (a copy of
`lemo_tpu/utils/raster.py`, which imports no JAX).

Replaces the reference's pyrender offscreen pipeline
(temp_prox/renderer.py:60-140: IntrinsicsCamera + directional light +
RGBA render alpha-blended over the recording's Color frame). pyrender/EGL
is not available here, so this renders the body mesh with a classic
z-buffered barycentric rasterizer (numpy, per-face bounding boxes) and the
same shading model (0.3 ambient + camera-directed lambertian) and blends
it over the image with the rendered alpha mask.

Offline tool — host numpy, seconds per frame at SMPL-X scale; the fitting
steps never call this (the PROX driver's mesh/render saver and
`cli/render_fitting.py` do, after the fit).
"""

from __future__ import annotations

import numpy as np

PINK = (1.0, 193 / 255.0, 193 / 255.0)


def rasterize_mesh(verts_cam: np.ndarray, faces: np.ndarray,
                   width: int, height: int,
                   fx: float, fy: float, cx: float, cy: float):
    """Render (depth, shade, mask) images of a camera-space mesh.

    verts_cam [V, 3] (+z forward), faces [F, 3]. Returns
    (zbuf [H, W] float inf-initialized, shade [H, W] float in [0, 1],
    mask [H, W] bool). Flat shading: 0.3 ambient + 0.7 * |n . view|.
    """
    verts_cam = np.asarray(verts_cam, np.float64)
    faces = np.asarray(faces, np.int64)
    z = verts_cam[:, 2]
    u = verts_cam[:, 0] / np.maximum(z, 1e-6) * fx + cx
    v = verts_cam[:, 1] / np.maximum(z, 1e-6) * fy + cy

    tri_uv = np.stack([u[faces], v[faces]], axis=-1)     # [F, 3, 2]
    tri_z = z[faces]                                     # [F, 3]
    tri_v = verts_cam[faces]                             # [F, 3, 3]
    fn = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    fn_len = np.linalg.norm(fn, axis=1)
    center = tri_v.mean(axis=1)
    view = -center / np.maximum(np.linalg.norm(center, axis=1,
                                               keepdims=True), 1e-9)
    ndotv = np.abs((fn * view).sum(1) / np.maximum(fn_len, 1e-12))
    shade_f = 0.3 + 0.7 * ndotv

    ok = (tri_z > 1e-4).all(axis=1) & (fn_len > 1e-12)
    # screen-space bbox cull
    x0 = np.floor(tri_uv[:, :, 0].min(1)).astype(int)
    x1 = np.ceil(tri_uv[:, :, 0].max(1)).astype(int)
    y0 = np.floor(tri_uv[:, :, 1].min(1)).astype(int)
    y1 = np.ceil(tri_uv[:, :, 1].max(1)).astype(int)
    ok &= (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)

    zbuf = np.full((height, width), np.inf)
    shade = np.zeros((height, width))
    for f in np.nonzero(ok)[0]:
        xa, xb = max(x0[f], 0), min(x1[f] + 1, width)
        ya, yb = max(y0[f], 0), min(y1[f] + 1, height)
        if xa >= xb or ya >= yb:
            continue
        xs, ys = np.meshgrid(np.arange(xa, xb) + 0.5,
                             np.arange(ya, yb) + 0.5)
        (ax, ay), (bx, by), (cx2, cy2) = tri_uv[f]
        den = (by - cy2) * (ax - cx2) + (cx2 - bx) * (ay - cy2)
        if abs(den) < 1e-12:
            continue
        w0 = ((by - cy2) * (xs - cx2) + (cx2 - bx) * (ys - cy2)) / den
        w1 = ((cy2 - ay) * (xs - cx2) + (ax - cx2) * (ys - cy2)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth via 1/z interpolation
        invz = (w0 / tri_z[f, 0] + w1 / tri_z[f, 1] + w2 / tri_z[f, 2])
        depth = 1.0 / np.maximum(invz, 1e-12)
        tile_z = zbuf[ya:yb, xa:xb]
        win = inside & (depth < tile_z)
        tile_z[win] = depth[win]
        shade[ya:yb, xa:xb][win] = shade_f[f]
    return zbuf, shade, np.isfinite(zbuf)


def render_body_in_scene(body_verts_cam: np.ndarray, body_faces: np.ndarray,
                         scene_verts_cam: np.ndarray,
                         scene_faces: np.ndarray,
                         width: int, height: int,
                         fx: float, fy: float, cx: float, cy: float,
                         body_color=PINK, scene_color=(0.7, 0.7, 0.7),
                         bg=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Body mesh rendered inside the scene mesh, both in camera space —
    the reference's rendering_mode='3d' output (temp_prox/renderer.py:
    134-151: pyrender scene = static scene mesh + body mesh, same
    IntrinsicsCamera). Returns uint8 [H, W, 3].

    Two z-buffered passes composited by depth, so each mesh keeps its own
    flat-shaded color with correct mutual occlusion.
    """
    zb, sb, mb = rasterize_mesh(body_verts_cam, body_faces,
                                width, height, fx, fy, cx, cy)
    zs, ss, ms = rasterize_mesh(scene_verts_cam, scene_faces,
                                width, height, fx, fy, cx, cy)
    body_wins = mb & (zb <= zs)           # zs is +inf where scene absent
    scene_wins = ms & ~body_wins
    out = np.ones((height, width, 3)) * np.asarray(bg)[None, None]
    out[scene_wins] = ss[scene_wins, None] * np.asarray(scene_color)[None]
    out[body_wins] = sb[body_wins, None] * np.asarray(body_color)[None]
    return (np.clip(out, 0.0, 1.0) * 255).astype(np.uint8)


def render_body_overlay(verts_cam: np.ndarray, faces: np.ndarray,
                        image: np.ndarray,
                        fx: float, fy: float, cx: float, cy: float,
                        color=PINK) -> np.ndarray:
    """Alpha-blend the rendered body over a Color frame.

    image [H, W, 3] uint8 or float in [0, 1]; returns uint8 [H, W, 3] —
    the reference's `<frame>_output.png` (renderer.py:110-133: rendered
    RGBA over the flipped Color image, body pixels replace image pixels).
    """
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float64) / 255.0
    H, W = img.shape[:2]
    _, shade, mask = rasterize_mesh(verts_cam, faces, W, H, fx, fy, cx, cy)
    body_rgb = shade[..., None] * np.asarray(color)[None, None]
    out = np.where(mask[..., None], body_rgb, img)
    return (np.clip(out, 0.0, 1.0) * 255).astype(np.uint8)
