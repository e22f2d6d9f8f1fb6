"""Visualization helpers (port of `lemo_tpu/utils/viz.py`; reference
vis_opt_amass.py / viz_fitting.py / renderer.py capability).

The reference renders with open3d/pyrender, neither of which is available
headless here; the same information is drawn with matplotlib 3-D scatter/
line plots (markers, skeleton limbs, contact coloring), and the
open3d/pyrender paths are kept behind availability gates for interactive
environments.
"""

from __future__ import annotations

import numpy as np

# marker-graph edges for SSM2 skeleton plots (utils/utils.py:408-464)
LIMBS_MARKER_SSM2 = [
    (65, 63), (65, 39), (63, 9), (39, 9), (63, 64), (65, 66), (39, 56),
    (9, 26), (56, 1), (26, 1), (1, 61), (61, 38), (61, 8), (38, 52),
    (8, 22), (52, 33), (22, 3), (33, 31), (3, 31), (33, 57), (3, 27),
    (57, 45), (27, 14), (45, 48), (14, 18), (48, 59), (18, 29), (59, 32),
    (29, 2), (32, 51), (2, 21),
    (56, 40), (40, 43), (43, 53), (53, 42),
    (26, 5), (5, 10), (10, 13), (13, 23), (23, 12),
]

# body-joint limbs, 25-joint SMPL-X subset (utils/utils.py:296-324)
LIMBS_BODY = [
    (23, 15), (24, 15), (15, 22), (22, 12), (12, 13), (13, 16), (16, 18),
    (18, 20), (12, 14), (14, 17), (17, 19), (19, 21), (12, 9), (9, 6),
    (6, 3), (3, 0), (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5),
    (5, 8), (8, 11),
]


def plot_marker_frame(ax, markers: np.ndarray, color="C0",
                      contact: np.ndarray | None = None,
                      limbs=LIMBS_MARKER_SSM2):
    """Draw one [67, 3] marker frame on a 3-D matplotlib axis; contact [4]
    colors heel/toe markers red when in contact (vis_opt_amass.py
    semantics)."""
    ax.scatter(markers[:, 0], markers[:, 1], markers[:, 2], s=6, c=color)
    for a, b in limbs:
        if a < len(markers) and b < len(markers):
            seg = markers[[a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=color, lw=0.8)
    if contact is not None:
        foot_slots = [16, 47, 30, 60]
        for slot, c in zip(foot_slots, contact):
            if c > 0.5:
                m = markers[slot]
                ax.scatter([m[0]], [m[1]], [m[2]], s=30, c="red")


def save_marker_animation(markers_seq: np.ndarray, out_path: str,
                          contact_seq: np.ndarray | None = None,
                          second_seq: np.ndarray | None = None,
                          stride: int = 4, max_frames: int = 16):
    """Save a grid of marker-skeleton frames as a png (the headless
    replacement for the open3d animation windows)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = list(range(0, len(markers_seq), stride))[:max_frames]
    cols = min(4, len(frames))
    rows = (len(frames) + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for i, t in enumerate(frames):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        plot_marker_frame(ax, markers_seq[t], "C0",
                          None if contact_seq is None else contact_seq[t])
        if second_seq is not None:
            plot_marker_frame(ax, second_seq[t], "C3")
        ax.set_title(f"t={t}", fontsize=8)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=90)
    plt.close(fig)
    return out_path


def render_fit_overlay(vertices: np.ndarray, faces: np.ndarray,
                       image: np.ndarray, camera, out_path: str):
    """Project the fitted mesh into the frame and overlay its silhouette
    (the pyrender overlay's information content, renderer.py). `camera`:
    a `fitting.prox.camera.PerspectiveCamera`; the projection runs on the
    host."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    pts = camera.project(torch.as_tensor(
        np.asarray(vertices, np.float32))).numpy()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.imshow(image)
    ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c="cyan", alpha=0.4)
    ax.set_axis_off()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path
