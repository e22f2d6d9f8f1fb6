"""SMPL-X body-segment vertex sets, read from the port's own copy of
`body_segments.npz` (byte-identical to `lemo_tpu/assets/`)."""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "body_segments.npz")


# default contact parts of the PROX scene-contact loss and the friction
# parts (fit_temp_loadprox_slide.py:349-362)
DEFAULT_CONTACT_PARTS = ["L_Leg", "R_Leg", "L_Hand", "R_Hand", "gluteus",
                         "back", "thighs"]
FRICTION_PARTS = ["L_Leg", "R_Leg", "gluteus"]


@lru_cache(maxsize=1)
def _load() -> dict[str, np.ndarray]:
    with np.load(_ASSET) as z:
        return {k: z[k].copy() for k in z.files}


def segment_vertex_ids(part: str, num_verts: int | None = None) -> np.ndarray:
    """Vertex ids of a named body segment; for reduced synthetic meshes
    the ids are rescaled proportionally into [0, num_verts) and
    deduplicated."""
    ids = _load()[part]
    if num_verts is not None and ids.max() >= num_verts:
        ids = np.unique(ids.astype(np.int64) * num_verts // 10475)
        ids = np.minimum(ids, num_verts - 1)
    return ids


def foot_vertex_ids(num_verts: int | None = None) -> dict[str, np.ndarray]:
    """{left_heel, right_heel, left_toe, right_toe} -> vertex ids (the
    Stage-2 friction sets)."""
    return {
        f"{side}_{part}": segment_vertex_ids(f"{side}_{part}_ids", num_verts)
        for side in ("left", "right") for part in ("heel", "toe")
    }


def contact_vertex_ids(parts=None, num_verts: int | None = None) -> np.ndarray:
    parts = DEFAULT_CONTACT_PARTS if parts is None else parts
    return np.concatenate([segment_vertex_ids(p, num_verts) for p in parts])


def friction_vertex_ids(num_verts: int | None = None) -> np.ndarray:
    return np.concatenate(
        [segment_vertex_ids(p, num_verts) for p in FRICTION_PARTS])


def head_and_body_masks(num_verts: int) -> tuple[np.ndarray, np.ndarray]:
    """(head_mask, body_mask) bool [num_verts]: the depth-term vertex
    split (fit_temp_loadprox_slide.py:420-426)."""
    head_ids = segment_vertex_ids("head_mask_ids", num_verts)
    head = np.zeros(num_verts, bool)
    head[head_ids % num_verts] = True
    return head, ~head
