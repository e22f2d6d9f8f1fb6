"""Checks of a marker sheet (`utils.viz.save_marker_animation`) against
the port's own view of the same arguments, pixel by pixel: the sheet's
size; at each marker's pixel its colour (C0, C3 for the second sequence,
red for a contact), unless a disc painted later covers that pixel; red
nowhere else among the contact slots; something drawn at each limb's
midpoint; dark pixels in each title band."""

from __future__ import annotations

import numpy as np

from lemo_tpu_torch.utils import viz
from lemo_tpu_torch.utils.plot3d import COLORS, TITLE_ABOVE, view_to_pixels


def _covered(px: int, py: int, later: list) -> bool:
    """Whether a disc of `later` (u, v, radius, rgb) paints pixel
    (px, py), by `plot3d.disc_cover`'s rule."""
    if not later:
        return False
    u, v, r = (np.array([d[k] for d in later]) for k in range(3))
    return bool((((px + 0.5 - u) ** 2 + (py + 0.5 - v) ** 2 <= r * r)
                 | ((np.floor(u) == px) & (np.floor(v) == py))).any())


def _pixel(img: np.ndarray, u: float, v: float):
    """(px, py) of the pixel holding (u, v), or None off the sheet."""
    px, py = int(np.floor(u)), int(np.floor(v))
    inside = 0 <= px < img.shape[1] and 0 <= py < img.shape[0]
    return (px, py) if inside else None


def sheet_faults(img: np.ndarray, markers_seq: np.ndarray,
                 contact_seq: np.ndarray | None = None,
                 second_seq: np.ndarray | None = None, stride: int = 4,
                 max_frames: int = 16) -> tuple[list, dict]:
    """(faults, counts) of sheet `img` [H, W, 3] drawn from these
    arguments. `counts`: discs whose pixel was checked and all discs,
    contact labels above 0.5 in the drawn frames and red slots seen,
    limbs."""
    frames, panels = viz.marker_panels(markers_seq, contact_seq, second_seq,
                                       stride, max_frames)
    cols = min(4, len(frames))
    rows = (len(frames) + cols - 1) // cols
    shape = (rows * viz.PANEL_PX, cols * viz.PANEL_PX, 3)
    if img.shape != shape:
        return [f"sheet {img.shape}, expected {shape}"], {}
    faults = []
    n = dict(checked=0, discs=0, contacts=0, red_seen=0, limbs=0)
    red = np.array(COLORS["red"])
    for i, (t, ax) in enumerate(zip(frames, panels)):
        box = viz.panel_box(i, cols)
        segs, discs = ax.layout(box, viz.SHEET_DPI)
        n["discs"] += len(discs)
        for k, (u, v, _, rgb) in enumerate(discs):
            at = _pixel(img, u, v)
            if at is None or _covered(*at, discs[k + 1:]):
                continue
            px, py = at
            n["checked"] += 1
            if tuple(img[py, px]) != tuple(rgb):
                faults.append(f"t={t}: pixel ({px}, {py}) {img[py, px]}, "
                              f"expected {rgb}")
        tx, ty, _ = ax.project(markers_seq[t][list(viz.FOOT_SLOTS)])
        us, vs = view_to_pixels(tx, ty, box)
        reds = [d for d in discs if tuple(d[3]) == tuple(red)]
        labels = (np.zeros(4) if contact_seq is None
                  else np.asarray(contact_seq[t]))
        for slot, label, u, v in zip(viz.FOOT_SLOTS, labels, us, vs):
            n["contacts"] += int(label > 0.5)
            at = _pixel(img, u, v)
            if at is None:
                continue
            is_red = bool((img[at[1], at[0]] == red).all())
            n["red_seen"] += int(label > 0.5 and is_red)
            if label <= 0.5 and is_red and not _covered(*at, reds):
                faults.append(f"t={t}: slot {slot} red, label {label}")
        for u0, v0, u1, v1, _ in segs:
            n["limbs"] += 1
            at = _pixel(img, 0.5 * u0 + 0.5 * u1, 0.5 * v0 + 0.5 * v1)
            if at is not None and (img[at[1], at[0]] == 255).all():
                faults.append(f"t={t}: limb midpoint {at} white")
        left, top, side = box
        band = img[top - TITLE_ABOVE:top - TITLE_ABOVE + 7, left:left + side]
        if not (band.max(-1) < 100).any():
            faults.append(f"t={t}: no dark pixel in the title band")
    if n["checked"] < 0.5 * n["discs"]:
        faults.append(f"only {n['checked']} of {n['discs']} discs visible")
    return faults, n
