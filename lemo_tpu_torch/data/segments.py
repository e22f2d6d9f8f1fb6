"""SMPL-X body-segment vertex sets, read from the port's own copy of
`body_segments.npz` (byte-identical to `lemo_tpu/assets/`)."""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "body_segments.npz")


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
