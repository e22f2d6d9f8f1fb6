"""Visualization helpers (port of `lemo_tpu/utils/viz.py`; reference
vis_opt_amass.py / viz_fitting.py / renderer.py capability).

The reference renders with open3d/pyrender, neither of which is available
headless; the same information is drawn by the port's own numpy painter
(`utils.plot3d`: mplot3d's view, markers, skeleton limbs, contact
colouring) and written by `data.png.write_png`, the same on the CPU and
on the card's host.
"""

from __future__ import annotations

import numpy as np

from lemo_tpu_torch.utils.plot3d import COLORS, Panel

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


# the heel and toe markers that the contact labels colour, in their order
FOOT_SLOTS = (16, 47, 30, 60)

# a sheet panel: 3 in at 90 dpi, the title band above the view square
SHEET_DPI = 90
PANEL_PX = 3 * SHEET_DPI
_TITLE_PX = 16


def panel_box(i: int, cols: int) -> tuple[int, int, int]:
    """(left, top, side) in pixels of panel `i`'s view square on a sheet
    of `cols` columns."""
    side = PANEL_PX - _TITLE_PX - 4
    r, c = divmod(i, cols)
    return (c * PANEL_PX + (PANEL_PX - side) // 2,
            r * PANEL_PX + _TITLE_PX, side)


def plot_marker_frame(ax: Panel, markers: np.ndarray, color="C0",
                      contact: np.ndarray | None = None,
                      limbs=LIMBS_MARKER_SSM2):
    """Draw one [67, 3] marker frame on a 3-D panel (`utils.plot3d.
    Panel`); contact [4] colors heel/toe markers red when in contact
    (vis_opt_amass.py semantics)."""
    ax.scatter(markers, s=6, color=color)
    segs = [markers[[a, b]] for a, b in limbs
            if a < len(markers) and b < len(markers)]
    if segs:
        ax.plot(np.stack(segs), color)
    if contact is not None:
        for slot, c in zip(FOOT_SLOTS, contact):
            if c > 0.5:
                ax.scatter(markers[slot], s=30, color="red")


def marker_panels(markers_seq: np.ndarray,
                  contact_seq: np.ndarray | None = None,
                  second_seq: np.ndarray | None = None, stride: int = 4,
                  max_frames: int = 16) -> tuple[list, list]:
    """(the frames drawn, a titled `Panel` for each) of a marker sheet."""
    frames = list(range(0, len(markers_seq), stride))[:max_frames]
    panels = []
    for t in frames:
        ax = Panel()
        plot_marker_frame(ax, markers_seq[t], "C0",
                          None if contact_seq is None else contact_seq[t])
        if second_seq is not None:
            plot_marker_frame(ax, second_seq[t], "C3")
        ax.title = f"t={t}"
        panels.append(ax)
    return frames, panels


def save_marker_animation(markers_seq: np.ndarray, out_path: str,
                          contact_seq: np.ndarray | None = None,
                          second_seq: np.ndarray | None = None,
                          stride: int = 4, max_frames: int = 16):
    """Save a grid of marker-skeleton frames as a png (the headless
    replacement for the open3d animation windows): at most 4 columns of
    3-inch panels at 90 dpi, lemo_tpu's sheet size."""
    from lemo_tpu_torch.data.png import write_png

    frames, panels = marker_panels(markers_seq, contact_seq, second_seq,
                                   stride, max_frames)
    cols = min(4, len(frames))
    rows = (len(frames) + cols - 1) // cols
    img = np.full((rows * PANEL_PX, cols * PANEL_PX, 3), 255, np.uint8)
    for i, ax in enumerate(panels):
        ax.draw(img, panel_box(i, cols), SHEET_DPI)
    write_png(out_path, img)
    return out_path


def render_fit_overlay(vertices: np.ndarray, faces: np.ndarray,
                       image: np.ndarray, camera, out_path: str):
    """Project the fitted mesh into the frame and mark its vertices
    (the pyrender overlay's information content, renderer.py). `camera`:
    a `fitting.prox.camera.PerspectiveCamera`; the projection runs on the
    host. The png is the frame [H, W, 3] uint8 at its own size, each pixel
    holding a projected vertex blended 0.4 toward cyan; lemo_tpu saves a
    bbox-cropped 8x4.5-inch figure instead, so the two sizes differ."""
    import torch

    from lemo_tpu_torch.data.png import write_png

    pts = camera.project(torch.as_tensor(
        np.asarray(vertices, np.float32))).numpy()
    out = np.array(image, np.uint8)
    H, W = out.shape[:2]
    uv = np.floor(pts[np.isfinite(pts).all(1)]).astype(np.int64)
    uv = uv[(uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
            & (uv[:, 1] < H)]
    hit = np.zeros((H, W), bool)
    hit[uv[:, 1], uv[:, 0]] = True
    out[hit] = np.rint(0.6 * out[hit] + 0.4 * np.array(COLORS["cyan"]))
    write_png(out_path, out)
    return out_path
