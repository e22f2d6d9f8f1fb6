"""Trilinear sampling of scene signed-distance grids (port of
`lemo_tpu/ops/sdf.py`).

Semantics of torch `grid_sample` with `padding_mode='border'`,
`align_corners=False` and the reference's axis permutation folded in:
`sdf[x, y, z]` is sampled at the point's (x, y, z)
(fitting_temp_slide.py:686-694).

`lemo_tpu` packs the grid into uint32 words to halve (bf16 pairs) or
quarter (fp8 quads) the TPU's per-element gathers. The port keeps the
grid in f32 and reproduces what those modes compute, not their packing:
the grid is quantized once at load (`quantize_grid`: bf16 or fp8 e4m3 and
back to f32), and the sampler takes the packed forms' corners. A packed
bf16 pair spans (k, min(k+1, D-1)) and an fp8 quad (j..j+1, k..k+1), each
clamped at the FULL grid's edge, while the f32 path clamps every corner
to the (possibly cropped) grid it samples; the samplers below keep that
difference so the values equal the JAX sampler's at the border too.
"""

from __future__ import annotations

import torch

MODES = ("f32", "bf16", "fp8")


def quantize_grid(grid: torch.Tensor, mode: str) -> torch.Tensor:
    """The grid as its packed form holds it: f32 (unchanged), bf16 or fp8
    e4m3 (round to nearest even), returned as f32."""
    if mode == "f32":
        return grid.float()
    if mode == "bf16":
        return grid.float().to(torch.bfloat16).float()
    if mode == "fp8":
        return grid.float().to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown SDF mode {mode!r} (expected one of {MODES})")


def normalize_points(points: torch.Tensor, grid_min: torch.Tensor,
                     grid_max: torch.Tensor) -> torch.Tensor:
    """World points -> [-1, 1]^3 grid coordinates
    (fitting_temp_slide.py:686)."""
    return (points - grid_min) / (grid_max - grid_min) * 2.0 - 1.0


def _lerp(a, b, f):
    return a * (1 - f) + b * f


def sample_grid_trilinear(grid: torch.Tensor, coords: torch.Tensor,
                          mode: str = "f32",
                          start: tuple[int, int, int] = (0, 0, 0),
                          size: tuple[int, int, int] | None = None
                          ) -> torch.Tensor:
    """grid [D0, D1, D2] (already quantized for `mode`); coords [..., 3]
    in [-1, 1] over the sub-grid `grid[start : start + size]` (the whole
    grid by default; `start` may be an int64 tensor broadcasting against
    coords, a sub-grid per point). Border padding, align_corners=False."""
    D = grid.shape
    size = tuple(D) if size is None else tuple(size)
    dims = torch.tensor(size, dtype=coords.dtype, device=coords.device)
    pix = ((coords + 1.0) * dims - 1.0) / 2.0
    lo = torch.floor(pix)
    frac = pix - lo
    maxi = dims - 1
    c0 = torch.minimum(torch.clamp(lo, min=0), maxi).long()
    c1 = torch.minimum(torch.clamp(lo + 1.0, min=0), maxi).long()
    st = (start if torch.is_tensor(start)
          else torch.tensor(start, dtype=torch.long, device=coords.device))
    g0, g1 = c0 + st, c1 + st
    flat = grid.reshape(-1)
    D1, D2 = D[1], D[2]

    def take(i0, i1, i2):
        return flat[(i0 * D1 + i1) * D2 + i2]

    x0, y0, z0 = g0.unbind(-1)
    x1, y1, z1 = g1.unbind(-1)
    if mode == "bf16":
        # the pair holds k and k+1 of the full grid
        z1 = torch.clamp(z0 + 1, max=D2 - 1)
    elif mode == "fp8":
        # the quad holds (j..j+1, k..k+1) of the full grid
        y1 = torch.clamp(y0 + 1, max=D1 - 1)
        z1 = torch.clamp(z0 + 1, max=D2 - 1)
    fx, fy, fz = frac.unbind(-1)

    if mode == "fp8":
        # the JAX quad sampler blends k, then j, then i
        def quad(i0):
            vk0 = _lerp(take(i0, y0, z0), take(i0, y0, z1), fz)
            vk1 = _lerp(take(i0, y1, z0), take(i0, y1, z1), fz)
            return _lerp(vk0, vk1, fy)

        return _lerp(quad(x0), quad(x1), fx)
    v00 = _lerp(take(x0, y0, z0), take(x0, y0, z1), fz)
    v01 = _lerp(take(x0, y1, z0), take(x0, y1, z1), fz)
    v10 = _lerp(take(x1, y0, z0), take(x1, y0, z1), fz)
    v11 = _lerp(take(x1, y1, z0), take(x1, y1, z1), fz)
    return _lerp(_lerp(v00, v01, fy), _lerp(v10, v11, fy), fx)


def sample_sdf_world(sdf_grid: torch.Tensor, points_world: torch.Tensor,
                     grid_min: torch.Tensor, grid_max: torch.Tensor,
                     crop: int | None = 128, mode: str = "f32"
                     ) -> torch.Tensor:
    """SDF values at world points [..., 3] -> [...].

    With `crop`, sampling is restricted to a crop^3 window placed at the
    points' bounding box (as `lemo_tpu` slices it for the TPU's gathers):
    identical values whenever the points fit the window, and points
    outside clamp to the window's border. The window's start is read back
    to the host (one sync), since it sets the sampling grid's extent.
    `sdf_grid` must already be quantized for `mode` (`quantize_grid`).
    """
    if crop is not None and min(sdf_grid.shape) > crop:
        Dt = torch.tensor(sdf_grid.shape, dtype=points_world.dtype,
                          device=points_world.device)
        cell = (grid_max - grid_min) / Dt
        pts = points_world.detach().reshape(-1, 3)
        lo_cell = torch.floor((pts.min(dim=0).values - grid_min) / cell) - 1
        starts = torch.minimum(torch.clamp(lo_cell, min=0), Dt - crop)
        starts_i = tuple(int(s) for s in starts.long().tolist())
        sub_min = grid_min + starts.to(points_world.dtype) * cell
        sub_max = sub_min + crop * cell
        coords = normalize_points(points_world, sub_min, sub_max)
        return sample_grid_trilinear(sdf_grid, coords, mode, starts_i,
                                     (crop, crop, crop))
    coords = normalize_points(points_world, grid_min, grid_max)
    return sample_grid_trilinear(sdf_grid, coords, mode)


def sample_sdf_windows(sdf_grid: torch.Tensor, points_world: torch.Tensor,
                       grid_min: torch.Tensor, grid_max: torch.Tensor,
                       crop: int | None = 128, mode: str = "f32"
                       ) -> torch.Tensor:
    """`sample_sdf_world` of W windows in one pass: points [W, ..., 3] ->
    [W, ...], each window cropped at its own points' bounding box, as W
    calls would crop it (the JAX package `vmap`s the call over windows),
    with the crop starts kept on the device."""
    if crop is None or min(sdf_grid.shape) <= crop:
        return sample_sdf_world(sdf_grid, points_world, grid_min, grid_max,
                                crop=None, mode=mode)
    W = points_world.shape[0]
    Dt = torch.tensor(sdf_grid.shape, dtype=points_world.dtype,
                      device=points_world.device)
    cell = (grid_max - grid_min) / Dt
    pts = points_world.detach().reshape(W, -1, 3)
    lo_cell = torch.floor((pts.min(dim=1).values - grid_min) / cell) - 1
    starts = torch.minimum(torch.clamp(lo_cell, min=0), Dt - crop)  # [W, 3]
    shape = (W,) + (1,) * (points_world.dim() - 2) + (3,)
    sub_min = (grid_min + starts * cell).reshape(shape)
    sub_max = sub_min + crop * cell
    coords = normalize_points(points_world, sub_min, sub_max)
    return sample_grid_trilinear(sdf_grid, coords, mode,
                                 starts.long().reshape(shape),
                                 (crop, crop, crop))
