"""Carry parameters across from `lemo_tpu`'s numpy-convertible trees.

`from_numpy_tree` keeps the keys and turns leaves into float32 tensors on
one device. It covers the VPoser and infill-AE params (torch-layout
state-dict keys), the smoothness-encoder params, a `GlobalStats` (any
object with `Xmean`/`Xstd` arrays) and a `Local4ChanStats` (any object
with its six fields). `prox_static_from_numpy` carries a PROX window's
constants across. The body model needs no conversion: `load_model` reads
the same npz dict.
"""

from __future__ import annotations

import numpy as np
import torch

from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats

# ProxStatic fields that index (int64 in the port) or mask (bool)
_ID_FIELDS = ("contact_verts_ids", "fric_verts_ids", "smooth_marker_ids",
              "infill_marker_ids", "sdf_candidate_ids",
              "depth_scan_cand_ids", "depth_vert_cand_ids", "faces_vis",
              "faces", "faces_segm", "coll_candidate_ids")
_MASK_FIELDS = ("scan_mask", "body_mask", "depth_vis_frozen", "ign_table")


def from_numpy_tree(tree, device):
    """dict (nested) of arrays -> same keys with tensors on `device`;
    an object with Xmean/Xstd -> the port's GlobalStats."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if hasattr(tree, "Xmean_local"):
        return Local4ChanStats.from_numpy(tree, device)
    if hasattr(tree, "Xmean") and hasattr(tree, "Xstd"):
        return GlobalStats.from_numpy(np.asarray(tree.Xmean),
                                      np.asarray(tree.Xstd), device)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def prox_static_from_numpy(st, device, sdf_mode: str | None = None):
    """Any object with `lemo_tpu`'s ProxStatic fields (arrays as numpy or
    anything `np.asarray` takes) -> the port's ProxStatic on `device`.
    Id fields become int64, masks bool.
    `sdf_packed` is not carried (the JAX package packs it into uint32
    words); with `sdf_mode` ('bf16' or 'fp8') the port's quantized grid is
    built from `sdf` instead."""
    import dataclasses

    from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera
    from lemo_tpu_torch.fitting.prox.losses import ProxStatic
    from lemo_tpu_torch.ops.sdf import quantize_grid

    kw = {}
    for f in dataclasses.fields(ProxStatic):
        v = getattr(st, f.name, None)
        if v is None or f.name == "sdf_packed":
            kw[f.name] = None
        elif f.name == "camera":
            kw[f.name] = PerspectiveCamera(float(v.focal_length_x),
                                           float(v.focal_length_y),
                                           tuple(float(c) for c in v.center))
        elif f.name == "image_size":
            kw[f.name] = tuple(v)
        elif f.name == "foot_ids":
            kw[f.name] = {k: np.asarray(x, np.int64) for k, x in v.items()}
        elif f.name in ("smooth_enc_params", "smooth_stats"):
            kw[f.name] = from_numpy_tree(v, device)
        elif f.name in _ID_FIELDS:
            kw[f.name] = torch.as_tensor(np.asarray(v, np.int64),
                                         device=device)
        elif f.name in _MASK_FIELDS:
            kw[f.name] = torch.as_tensor(np.asarray(v).astype(bool),
                                         device=device)
        else:
            kw[f.name] = from_numpy_tree(np.asarray(v), device)
    if sdf_mode is not None and kw["sdf"] is not None:
        kw["sdf_packed"] = quantize_grid(kw["sdf"], sdf_mode)
    return ProxStatic(**kw)
