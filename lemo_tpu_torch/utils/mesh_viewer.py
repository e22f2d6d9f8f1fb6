"""Offscreen mesh/point visualization grids (port of
`lemo_tpu/utils/mesh_viewer.py`).

Capability parity with human_body_prior/mesh/{mesh_viewer.py, sphere.py}
and utils/notebook_tools.py: offscreen multi-mesh image grids and sphere
point visualizations. pyrender/trimesh are unavailable headless; meshes
render through the host rasterizer's z-buffer and shading
(`utils.raster.rasterize_mesh`) under mplot3d's view (`utils.plot3d`),
points through the port's painter, and grids are written by
`data.png.write_png`. The one difference from lemo_tpu's interface:
`show_image_grid` without `outpath` returns the tiled image array, not a
figure.
"""

from __future__ import annotations

import numpy as np

from lemo_tpu_torch.utils.plot3d import (COLORS, VIEW_HI, VIEW_LO, Panel,
                                         autoscale, view_matrices,
                                         view_to_pixels)


def view_box(size: tuple) -> tuple[float, float, int]:
    """(left, top, side) of the view square of a `size` = (W, H) image:
    the largest square, centred."""
    side = min(size)
    return (size[0] - side) / 2, (size[1] - side) / 2, side


def render_mesh_image(vertices: np.ndarray, faces: np.ndarray | None = None,
                      size: tuple = (400, 400), elev: float = 10.0,
                      azim: float = -60.0) -> np.ndarray:
    """One [V, 3] mesh (or point cloud) -> RGB image [size[1], size[0], 3]
    uint8 on white: the faces z-buffered and shaded, in C0 at alpha 0.8,
    each vertex's pixel that no face covers in C0 (the faces' edges); or,
    with `faces` None, 1-point² dots at 100 dpi."""
    from lemo_tpu_torch.utils.raster import rasterize_mesh

    W, H = size
    box = view_box(size)
    img = np.full((H, W, 3), 255, np.uint8)
    ax = Panel(elev, azim)
    ax.scatter(vertices, s=1, color="C0")
    if faces is None or not len(faces):
        ax.draw(img, box, dpi=100)
        return img
    m0 = view_matrices(autoscale(vertices), elev, azim)[0]
    eye = (m0 @ np.vstack([np.asarray(vertices, np.float64).T,
                           np.ones(len(vertices))]))[:3].T
    # the rasterizer's camera looks down +z with image rows down: the
    # view's (x, -y, -z); its pinhole is the view square's scale
    left, top, side = box
    f = side / (VIEW_HI - VIEW_LO)
    _, shade, mask = rasterize_mesh(eye * [1.0, -1.0, -1.0], faces, W, H, f,
                                    f, left - VIEW_LO * f, top + VIEW_HI * f)
    face = 0.8 * shade[..., None] * np.array(COLORS["C0"]) + 0.2 * 255.0
    img[mask] = np.rint(face[mask])
    tx, ty, _ = ax.project(vertices)
    u, v = view_to_pixels(tx, ty, box)
    cols, rows = np.floor(u).astype(int), np.floor(v).astype(int)
    ok = (cols >= 0) & (cols < W) & (rows >= 0) & (rows < H)
    rows, cols = rows[ok], cols[ok]
    edge = ~mask[rows, cols]
    img[rows[edge], cols[edge]] = COLORS["C0"]
    return img


def _tile(images: list, rows: int, cols: int) -> np.ndarray:
    """The [H, W, 3] uint8 images in a rows x cols grid of cells of the
    largest height and width, each at its cell's top left, on white."""
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    out = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        out[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    return out


def imagearray2file(img_array: np.ndarray, outpath: str) -> str:
    """[R, C, H, W, 3] grid of images -> one tiled png
    (the mesh_viewer image-grid output format), each image at its own
    size (lemo_tpu's figure puts each in a 3-inch cell at 90 dpi)."""
    from lemo_tpu_torch.data.png import write_png

    R, C = img_array.shape[:2]
    write_png(outpath, _tile([img_array[r, c] for r in range(R)
                              for c in range(C)], R, C))
    return outpath


def points_to_spheres(points: np.ndarray, radius: float = 0.01,
                      color=(0.0, 0.0, 1.0)):
    """Sphere-marker description for point visualization (the sphere.py
    capability): returns a dict consumable by render_mesh_image-style
    plotting or an interactive viewer."""
    return {"centers": np.asarray(points), "radius": float(radius),
            "color": tuple(color)}


def show_image_grid(images: list, cols: int = 4, outpath: str | None = None):
    """Notebook-style image grid (utils/notebook_tools.py capability):
    `images` [H, W, 3] uint8 tiled `cols` to a row, each at its own size.
    Written to `outpath` as a png, which is returned; without `outpath`
    the tiled array is returned (lemo_tpu returns a figure)."""
    from lemo_tpu_torch.data.png import write_png

    grid = _tile(images, (len(images) + cols - 1) // cols, cols)
    if outpath:
        write_png(outpath, grid)
        return outpath
    return grid
